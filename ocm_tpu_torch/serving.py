"""Deployment-side scoring: resident models over fixed-size chunks (port of
``ocm_tpu/serving.py``'s chunk machinery and ``VAEScorer``).

``VAEScorer`` keeps one eval-mode module per class resident on the
bundle's device (``bundle.bind``, built once) and screens spectra in chunks
of ``chunk_size``: each chunk is padded to that size by repeating its last
row (so batch statistics -- variant 'f', quirk Q3 -- see the padded batch
that ``ocm_tpu`` sees), copied to the device, decided under
``torch.inference_mode()``, fetched, and cut back to its real rows (on a
CUDA device from and to page-locked memory, the chunk's copy on a stream
of its own: ``_ChunkedScorer``).
The convolutions run with cuDNN's deterministic algorithms, which the
package selects for the process when it loads (``ocm_tpu_torch``'s
``__init__``): with the card's default transposed convolutions a rerun of
the same 'vaesimca' chunk moved its Q by ~1e-6 of its scale
(``chip_smoke.py``).  Deterministic, a screen is a pure function of its
input, and a stacked screen equals its single-class screens bit for bit,
also with scorers deciding in several threads at once.

``SIMCAScorer`` screens spectra against one SIMCA model or a stack of C
(one read of each chunk for every class) at four storage widths: f32,
bf16 residuals, int8 residuals with per-row scales, and raw camera counts
(e.g. uint16) preprocessed on the device.  ``VAEScorer(compute_dtype=
torch.bfloat16)`` is the reduced-precision twin of the VAE scorer.
``VAEScorer.from_torch_checkpoint`` serves a reference ``.pth``.

``mesh=`` (a ``parallel.mesh.Mesh`` with a ``'data'`` axis; the models on
``mesh.device``) shards each padded chunk's rows over the ranks: each rank
prepares and decides its own rows (at every storage width: f32 and raw
through K1, bf16 through bf16 K1, int8 through K8), the outputs are
gathered, and ``score``/``score_prepared`` return the whole numpy dict on
every rank, as JAX's ``np.asarray`` of a sharded output does.
``chunk_size`` must divide by the axis size.  The VAE variants whose
statistics are batch-wide ('f' unpinned, 'full': quirks Q3/Q4) run the
network on each rank's rows, gather its per-row outputs and compute the
statistics over the whole chunk.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from typing import Iterable, Iterator

import numpy as np
import torch

from ocm_tpu_torch.models import vae_decision as D
from ocm_tpu_torch.models.bundle import (OCMBundle, bind, class_slice,
                                         decode, encode, standardize)
from ocm_tpu_torch.models.simca import (SIMCAModel, predict_classes,
                                        predict_classes_int8)
from ocm_tpu_torch.models.vae import ConvVAE1D
from ocm_tpu_torch.models.vaesimca import predict_vaesimca
from ocm_tpu_torch.stats.limits import LimitResult
from ocm_tpu_torch.stats.qhf import qhf_batch_host
from ocm_tpu_torch.utils import native, profiling


def _concat(outs: list) -> dict:
    if not outs:
        return {}
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def _pad_chunk(chunk: np.ndarray, size: int):
    n = chunk.shape[0]
    if n == size:
        return chunk, n
    out = np.zeros((size, chunk.shape[1]), chunk.dtype)
    out[:n] = chunk
    out[n:] = chunk[-1] if n else 0.0
    return out, n


def _padded(host: tuple, size: int, pin: bool = False) -> tuple:
    """Each tensor of a host stage in a new (page-locked, with ``pin``)
    buffer of ``size`` rows, its last row repeated below it: the stage of
    a padded chunk, since every host stage works row by row."""
    out = []
    for t in host:
        buf = torch.empty((size, *t.shape[1:]), dtype=t.dtype, pin_memory=pin)
        buf[:t.shape[0]].copy_(t)
        rest = buf[t.shape[0]:]
        rest.copy_(t[-1:].expand(rest.shape))
        out.append(buf)
    return tuple(out)


class _ChunkedScorer:
    """Shared machinery: fixed-size chunks, ragged tails padded.

    A subclass's ``host_chunk`` turns rows of a chunk (this rank's rows of
    it, under a mesh) into the tuple of CPU tensors (of any dtypes) to be
    put on the device, working row by row; ``decide_fn(*tensors) -> {name:
    tensor}`` decides them on the device; ``gathered_fn`` maps that dict
    over the whole chunk (gathered from the ranks under a mesh) to the
    decisions; ``post_fn`` is a host epilogue on the fetched numpy dict,
    applied before the pad rows are cut.

    The algorithm is chosen by the device, once.  On the CPU a chunk is
    padded, staged and decided as it is, and its outputs read in place.  On
    a CUDA device a chunk's host stage is padded into page-locked buffers
    (torch's caching host allocator: the first calls pin them, later ones
    reuse them), copied to the device on the scorer's own copy stream, and
    waited for there before the chunk is handed on, so that the copy
    overlaps the decisions already on the device and the decide's kernels
    are enqueued after it; each chunk's outputs are copied into page-locked
    host tensors behind one event, read after the next chunk's decide is
    enqueued.
    """

    def __init__(self, decide_fn, device, chunk_size: int = 8192, mesh=None,
                 post_fn=None, gathered_fn=None):
        self.chunk_size = int(chunk_size)
        if mesh is not None:
            from ocm_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                     require_mesh_axis)

            require_mesh_axis(mesh, DATA_AXIS)
            mesh.rows(self.chunk_size, DATA_AXIS)   # chunk_size must divide
        self._mesh = mesh
        self._fn, self._post, self._gathered = decide_fn, post_fn, gathered_fn
        self._device = torch.device(device)
        self._copy_stream = (torch.cuda.Stream(self._device)
                             if self._device.type == "cuda" else None)
        self._worker: ThreadPoolExecutor | None = None
        self._worker_lock = threading.Lock()

    def host_chunk(self, chunk: np.ndarray) -> tuple:
        raise NotImplementedError

    def to_device(self, host: tuple) -> tuple:
        """The copy stage: ``host_chunk``'s tensors on the models' device
        (from pageable memory, on the current stream)."""
        return tuple(t.to(self._device) for t in host)

    def _prepare_chunk(self, chunk: np.ndarray) -> tuple:
        """One padded chunk (this rank's rows of it) staged and copied
        from pageable memory: the path off CUDA."""
        return self.to_device(self.host_chunk(chunk))

    def close(self) -> None:
        """Stop the copy worker's thread now (freeing the scorer stops it
        too); a later call with ``prefetch`` starts it again."""
        with self._worker_lock:
            worker, self._worker = self._worker, None
        if worker is not None:
            worker.shutdown()

    def _copy_worker(self) -> ThreadPoolExecutor:
        """The scorer's copy worker: one thread fed by a queue, started
        once; it holds no reference to the scorer, and ends when the
        scorer (the executor's only owner) is freed."""
        with self._worker_lock:
            if self._worker is None:
                self._worker = ThreadPoolExecutor(
                    1, thread_name_prefix="ocm-serving-copy")
            return self._worker

    def _rows(self, x, start: int):
        """The rows of the chunk at ``start`` that this rank stages (all
        of it without a mesh) before padding, the rows they pad to, and
        the chunk's real rows.  Rows past the real ones repeat the last."""
        n = min(self.chunk_size, x.shape[0] - start)
        lo, hi = 0, self.chunk_size
        if self._mesh is not None:
            own = self._mesh.rows(self.chunk_size, "data")
            lo, hi = own.start, own.stop
        first = min(lo, n - 1)
        return x[start + first:start + max(min(hi, n), first + 1)], hi - lo, n

    def _send(self, res: dict):
        """Start a chunk's outputs towards the host: on a CUDA device each
        into page-locked memory on the current stream, behind one event."""
        if self._copy_stream is None:
            return res
        host = {k: v.to("cpu", non_blocking=True) for k, v in res.items()}
        return host, torch.cuda.current_stream(self._device).record_event()

    def _fetch(self, sent, n: int) -> dict:
        with profiling.span("serving.fetch"):
            if self._copy_stream is None:
                out = {k: v.cpu().numpy() for k, v in sent.items()}
            else:
                host, done = sent
                done.synchronize()
                out = {k: v.numpy() for k, v in host.items()}
            if self._post is not None:
                out = self._post(out)
            return {k: a[:n] for k, a in out.items()}

    def _decide(self, *args):
        with profiling.span("serving.decide"), torch.inference_mode():
            if self._copy_stream is not None:
                # staged on the copy stream: its memory is not reused
                # before the kernels enqueued here have read it
                stream = torch.cuda.current_stream(self._device)
                for t in args:
                    t.record_stream(stream)
            out = self._fn(*args)
            if self._mesh is not None:
                out = {k: self._mesh.all_gather(v, "data", k)
                       for k, v in out.items()}
            return out if self._gathered is None else self._gathered(out)

    def _prep(self, x, start, parent=None):
        """One chunk padded and on the device; ``parent``: the caller's
        ``serving.score`` span where this runs on the copy worker."""
        with profiling.span("serving.input", parent):
            if self._copy_stream is None:
                chunk, n = _pad_chunk(x[start:start + self.chunk_size],
                                      self.chunk_size)
                if self._mesh is not None:
                    chunk = chunk[self._mesh.rows(self.chunk_size, "data")]
                args = self._prepare_chunk(chunk)
            else:
                rows, size, n = self._rows(x, start)
                staged = _padded(self.host_chunk(rows), size, pin=True)
                with torch.cuda.stream(self._copy_stream):
                    args = tuple(t.to(self._device, non_blocking=True)
                                 for t in staged)
                    done = self._copy_stream.record_event()
                # the span holds its copy, the decide's kernels follow it
                done.synchronize()
                profiling.count("serving.h2d_bytes_pinned",
                                sum(t.nbytes for t in args))
            profiling.count("serving.h2d_bytes", sum(t.nbytes for t in args))
            return args, n

    def _drain(self, chunks) -> dict:
        """Decide each (device tensors, real rows) of ``chunks``; a chunk's
        outputs are read after the next chunk's decide is enqueued."""
        outs, last = [], None
        for args, n in chunks:
            sent = self._send(self._decide(*args)), n
            del args        # not held on the device through the wait below
            if last is not None:
                outs.append(self._fetch(*last))
            last = sent
        if last is not None:
            outs.append(self._fetch(*last))
        return _concat(outs)

    def prepare(self, x) -> list:
        """Ingest once, score many: pad and place every chunk on the device
        now and return the list; ``score_prepared`` then only decides.  All
        chunks are resident at once; for a one-shot screen larger than the
        device memory use ``score``."""
        with profiling.span("serving.prepare"):
            x = np.asarray(x)
            return [self._prep(x, s)
                    for s in range(0, x.shape[0], self.chunk_size)]

    def score_prepared(self, prepared: list) -> dict:
        with profiling.span("serving.score"):
            return self._drain(prepared)

    def score(self, x, prefetch: int = 1) -> dict:
        """Score an (N, L) array in fixed-size chunks; returns a dict of
        numpy arrays ('accept' plus the variant's statistics), which share
        no memory with the scorer's buffers.

        Device residency stays O((2 + prefetch) * chunk_size).  With
        ``prefetch`` > 0 the scorer's copy worker (one resident thread,
        started at the first such call) stages the next chunks and copies
        them to the device while the current one is decided; 0 stages each
        chunk on the calling thread after the previous one's decide is
        enqueued.  A single chunk never uses the worker.  Calls from
        several threads share the worker and each get their own answers.

        While tracing is on (``utils.profiling``), the call records the
        spans ``serving.score``, and per chunk ``serving.input`` (host
        stage and copy), ``serving.wait_input`` (with the worker),
        ``serving.decide`` and ``serving.fetch``, and counts
        ``serving.h2d_bytes`` (and on a CUDA device
        ``serving.h2d_bytes_pinned``, the bytes copied from page-locked
        memory): the worker records exactly when its caller does.
        """
        with profiling.span("serving.score") as call:
            # the call's locals (futures, chunks) are freed when _score
            # returns, inside the span
            return self._score(x, prefetch, call)

    def _score(self, x, prefetch: int, call) -> dict:
        x = np.asarray(x)
        starts = range(0, x.shape[0], self.chunk_size)
        if prefetch <= 0 or len(starts) <= 1:
            return self._drain(self._prep(x, s) for s in starts)
        submit = self._copy_worker().submit
        rest = iter(starts)
        pending = deque(submit(self._prep, x, s, call)
                        for s in islice(rest, 1 + prefetch))

        def inputs():
            while pending:
                with profiling.span("serving.wait_input"):
                    got = pending.popleft().result()
                for s in islice(rest, 1):
                    pending.append(submit(self._prep, x, s, call))
                yield got

        return self._drain(inputs())

    def score_stream(self, chunks: Iterable) -> Iterator[dict]:
        """One result dict per array of an iterable (e.g. camera frames)."""
        for chunk in chunks:
            yield self.score(chunk)


def _stack1(model: SIMCAModel) -> SIMCAModel:
    """One model as a stack of one (a class axis on every leaf)."""
    return SIMCAModel(*(LimitResult(*(a[None] for a in v))
                        if isinstance(v, LimitResult) else v[None]
                        for v in model))


def _host_f32(a) -> np.ndarray:
    return a.detach().cpu().numpy().astype(np.float32)


class SIMCAScorer(_ChunkedScorer):
    """Resident classical-SIMCA scorer, single or multi-class.

    A stacked model (``models.simca.fit_classes``) screens every class from
    one read of each chunk (kernel K1); outputs then carry a trailing
    class axis: ``accept``/``dred``/``t2``/``q`` are (N, C).  Multi-class
    chunks are always centered on the host against ``center``, by default
    the mean of the class means; the offset folds into the class means.

    ``store_dtype``:
    - None: chunks ship in f32 (4 B an element) through K1: a multi-class
      chunk as its host-centered residual, a single-class chunk as it is
      (or centered, when ``center`` is given);
    - ``torch.bfloat16``: the host-centered residual (against the model
      mean, or ``center``) cast to bf16 on the host (round to nearest even,
      as ``ml_dtypes``), 2 B an element; K1 reads it at half width and
      keeps means, loadings and statistics f32;
    - ``torch.int8``: each residual row centered and quantized to int8
      with a per-row f32 scale and its exact squared norm in one threaded
      host pass (``utils.native.quantize_rows_int8``), 1 B an element + 8
      B a row; the device scores through the exact int8 product (kernel
      K8), no K1.

    ``preprocess_fn`` (exclusive of ``store_dtype``) is raw ingest: chunks
    ship at their storage dtype (e.g. uint16 camera counts, 2 B an
    element, no host work) and the device widens them to f32, applies
    ``preprocess_fn`` (e.g. ``lambda x: snv_savgol(x, 5, 2, 1)``),
    subtracts the offset (multi-class) and scores through K1.

    ``center``: the (L,) f32 offset chunks are centered against.  To
    re-screen chunks prepared by one scorer against updated models, build
    the new scorer with ``center=old.center``.
    """

    def __init__(self, model: SIMCAModel, decision_type: str = "alt",
                 chunk_size: int = 8192, mesh=None, store_dtype=None,
                 center=None, preprocess_fn=None):
        if store_dtype not in (None, torch.bfloat16, torch.int8):
            raise ValueError(
                "store_dtype supports torch.bfloat16 or torch.int8")
        if preprocess_fn is not None and store_dtype is not None:
            raise ValueError(
                "preprocess_fn (raw device-side ingest) and store_dtype "
                "(host-quantized residual storage) are mutually exclusive: "
                "quantizing the residual requires the preprocessed spectrum "
                "on the host, which is exactly the work preprocess_fn moves "
                "onto the device")
        self._multiclass = model.mean.dim() == 2
        if center is not None:
            center = np.asarray(center, np.float32)
            length = model.mean.shape[-1]
            if center.shape != (length,):
                raise ValueError(
                    f"center must be a ({length},) spectrum (got shape "
                    f"{center.shape}); for re-screening pass the previous "
                    "scorer's .center")
        if (preprocess_fn is not None and not self._multiclass
                and center is not None):
            raise ValueError(
                "center= is for re-screening stored residual chunks and "
                "cannot be combined with preprocess_fn (raw ingest) on a "
                "single-class model")
        if center is None and (self._multiclass or store_dtype is not None):
            center = (np.mean(_host_f32(model.mean), axis=0)
                      if self._multiclass else _host_f32(model.mean))
        self._center, self._store_dtype = center, store_dtype
        self._raw_fn = preprocess_fn
        models = model if self._multiclass else _stack1(model)
        offset = None if center is None else torch.as_tensor(
            center, dtype=model.mean.dtype, device=model.mean.device)

        if store_dtype == torch.int8:
            def scores(xq, xs, x2):
                return predict_classes_int8(models, xq, xs, x2,
                                            decision_type, x_offset=offset)
        elif preprocess_fn is not None:
            def scores(x_raw):
                x = preprocess_fn(x_raw.to(torch.float32))
                if offset is not None:
                    x = x - offset
                return predict_classes(models, x, decision_type, offset)
        else:
            def scores(x):
                return predict_classes(models, x, decision_type, offset)

        def decide(*chunk):
            out = dict(zip(("accept", "dred", "t2", "q"), scores(*chunk)))
            # batch-leading (N, C), or (N,) for one model
            return {k: v.T if self._multiclass else v[0]
                    for k, v in out.items()}

        super().__init__(decide, model.mean.device, chunk_size, mesh)

    @property
    def center(self):
        """The f32 offset chunks are centered against (None: single-class
        f32 or raw chunks shipped as they are)."""
        return self._center

    def host_chunk(self, chunk: np.ndarray) -> tuple:
        """The host stage of rows of a chunk: the CPU tensors that go to
        the device (raw: the rows at their storage dtype; f32/bf16: the
        centered residual, bf16 cast on the host; int8: quantized rows,
        scales and row norms)."""
        if self._raw_fn is not None:          # raw: the storage dtype as is
            return (torch.from_numpy(np.ascontiguousarray(chunk)),)
        x = np.asarray(chunk, np.float32)
        if self._store_dtype == torch.int8:
            # one threaded pass a row: center, quantize and row norm fused
            # (ocm_tpu/serving.py:381-395)
            return tuple(map(torch.from_numpy, native.quantize_rows_int8(
                x, center=self._center)))
        if self._center is not None:
            x = x - self._center[None, :]
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self._store_dtype == torch.bfloat16:
            t = t.to(torch.bfloat16)          # on the host: 2 B to ship
        return (t,)


class _Bf16Twin(torch.nn.Module):
    """A bound module whose network passes run under ``torch.autocast`` in
    bf16 on its device type; latents and reconstructions come back widened
    to the input's dtype, so every statistic after them is computed at
    full width."""

    def __init__(self, bound: ConvVAE1D):
        super().__init__()
        self.net = bound
        self.bound_state = bound.bound_state
        self.eval()

    def encode(self, x):
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            mu, logvar = self.net.encode(x)
        return mu.to(x.dtype), logvar.to(x.dtype)

    def decode(self, z):
        with torch.autocast(z.device.type, dtype=torch.bfloat16):
            x_rec = self.net.decode(z)
        return x_rec.to(z.dtype)


def _f_outputs(m, b, vm, xc):
    """Variant 'f''s per-row network outputs: standardized spectra and
    reconstructions, and mu (its statistics are batch-wide)."""
    mu, _ = encode(m, b, xc)
    x_rec = decode(m, b, mu)
    return {"x_std": standardize(b, xc), "r_std": standardize(b, x_rec),
            "mu": mu}


class VAEScorer(_ChunkedScorer):
    """Resident VAE one-class scorer over an ``OCMBundle``, single or
    multi-class.

    ``variant``: 'd2' | 'd2_q' | 'f' | 'full' (variants 2-4) or 'vaesimca'
    (variant 5, with the fitted ``vaesimca_model``).  A stacked bundle
    (``bundle.stack_bundles``) screens every class of a chunk in one call,
    class after class on their resident modules; outputs then carry a
    trailing class axis (N, C), and a 'vaesimca' model must be stacked over
    the same classes.  Each class's numbers are a single scorer's.

    ``pin_f_stats`` (variant 'f' only): the device runs the network and
    ships its outputs; the quirk-Q3 batch statistics run on the host in
    numpy float64 (``stats.qhf.qhf_batch_host``), so decisions are a pure
    function of the network outputs.

    The chunks go to the bundle's device in the bundle's dtype.
    ``compute_dtype=torch.bfloat16`` is the reduced-precision twin: the
    network passes of every variant run under ``torch.autocast`` in bf16
    on the bundle's device type, and latents and reconstructions are
    widened back to the bundle's dtype before any statistic, so every
    output other than ``accept`` keeps it.  The twin takes a float32
    bundle (autocast does not reduce float64).  ``mesh``: see the module
    docstring (the bundle on ``mesh.device``).
    """

    def __init__(self, model: ConvVAE1D, bundle: OCMBundle,
                 variant: str = "d2", loss_type: str = "cosine",
                 chunk_size: int = 8192, mesh=None, vaesimca_model=None,
                 decision_type: str = "alt", compute_dtype=None,
                 pin_f_stats: bool = False):
        if pin_f_stats and variant != "f":
            raise ValueError(
                "pin_f_stats applies only to variant='f' (the quirk-Q3 "
                f"batch statistics); got variant={variant!r}")
        if compute_dtype not in (None, torch.bfloat16):
            raise ValueError("compute_dtype supports torch.bfloat16 (the "
                             f"reduced-precision twin); got {compute_dtype}")
        if compute_dtype is not None and (bundle.spec_mean.dtype
                                          != torch.float32):
            # autocast leaves float64 tensors as they are: the twin would
            # quietly run at full width
            raise ValueError("compute_dtype=torch.bfloat16 reduces a "
                             "float32 bundle's network passes; this bundle "
                             f"is {bundle.spec_mean.dtype}")
        # a stacked bundle has a class axis on every leaf; key the
        # detection on latent_mean ((k,) or (C, k)), so a single-class
        # bundle with a (1,)-shaped threshold stays single-class
        self._multiclass = bundle.latent_mean.dim() == 2
        if self._multiclass and (
                bundle.threshold.dim() != 1
                or bundle.threshold.shape[0] != bundle.latent_mean.shape[0]):
            raise ValueError(
                "stacked bundle is inconsistent: latent_mean has a class "
                f"axis of {bundle.latent_mean.shape[0]} but threshold has "
                f"shape {tuple(bundle.threshold.shape)} — build stacked "
                "bundles with models.bundle.stack_bundles")
        n_cls = bundle.latent_mean.shape[0] if self._multiclass else 1
        bundles = ([class_slice(bundle, c) for c in range(n_cls)]
                   if self._multiclass else [bundle])
        post = None
        if variant == "vaesimca":
            if vaesimca_model is None:
                raise ValueError(
                    "variant='vaesimca' needs vaesimca_model from "
                    "ocm_tpu_torch.models.vaesimca.fit_vaesimca")
            if self._multiclass:
                if (vaesimca_model.d_limit.dim() != 1
                        or vaesimca_model.d_limit.shape[0] != n_cls):
                    raise ValueError(
                        "stacked bundle needs a vaesimca_model stacked over "
                        f"the same {n_cls} classes (stack_bundles)")
                vms = [class_slice(vaesimca_model, c) for c in range(n_cls)]
            else:
                vms = [vaesimca_model]

            def decide_one(m, b, vm, xc):
                accept, t2, q = predict_vaesimca(m, b, vm, xc, decision_type)
                return {"accept": accept, "t2": t2, "q": q}
        elif variant == "d2":
            def decide_one(m, b, vm, xc):
                return D.decide_d2(m, b, xc)._asdict()
        elif variant == "d2_q":
            def decide_one(m, b, vm, xc):
                return D.decide_d2_q(m, b, xc, loss_type)._asdict()
        elif variant == "f" and pin_f_stats:
            decide_one = _f_outputs
            thr = [float(b.threshold_f) for b in bundles]

            def post(d):
                cols = [qhf_batch_host(*(d[k][:, c] if self._multiclass
                                         else d[k]
                                         for k in ("x_std", "r_std", "mu")))
                        for c in range(n_cls)]
                out = {"accept": [f <= t for (_, _, f), t in zip(cols, thr)],
                       "d2": [h for _, h, _ in cols],
                       "q": [q for q, _, _ in cols]}
                if self._multiclass:
                    return {k: np.stack(v, axis=1) for k, v in out.items()}
                return {k: v[0] for k, v in out.items()}
        elif variant == "f":
            # batch-wide statistics (decide_f in two stages): per-row
            # network outputs, then the statistics over the whole chunk
            decide_one = _f_outputs

            def chunk_one(b, d):
                return D.f_decision(b, d["x_std"], d["r_std"],
                                    d["mu"])._asdict()
        elif variant == "full":
            # decide_full_distance in the same two stages
            def decide_one(m, b, vm, xc):
                q, mu, _ = D.reconstruction_errors(m, b, xc, "euclidean")
                return {"q": q, "mu": mu}

            def chunk_one(b, d):
                return D.full_distance_decision(b, d["q"], d["mu"])._asdict()
        else:
            raise ValueError(f"unknown variant {variant!r}; expected "
                             "d2|d2_q|f|full|vaesimca")
        if variant != "vaesimca":
            vms = [None] * n_cls
        self.modules = [bind(model, b) for b in bundles]
        if compute_dtype is not None:
            self.modules = [_Bf16Twin(m) for m in self.modules]
        classes = list(zip(self.modules, bundles, vms))

        def decide(xc):
            outs = [decide_one(m, b, vm, xc) for m, b, vm in classes]
            if self._multiclass:
                return {k: torch.stack([o[k] for o in outs], 1)
                        for k in outs[0]}
            return outs[0]

        gathered = None
        if variant in ("f", "full") and not pin_f_stats:
            def gathered(d):
                if not self._multiclass:
                    return chunk_one(bundles[0], d)
                # contiguous: a class's statistics reduce the same layout
                # as a single-class scorer's
                outs = [chunk_one(b, {k: v[:, c].contiguous()
                                      for k, v in d.items()})
                        for c, b in enumerate(bundles)]
                return {k: torch.stack([o[k] for o in outs], 1)
                        for k in outs[0]}

        self._dtype = bundle.spec_mean.dtype
        super().__init__(decide, bundle.spec_mean.device, chunk_size, mesh,
                         post_fn=post, gathered_fn=gathered)

    def host_chunk(self, chunk: np.ndarray) -> tuple:
        """The host stage of rows of a chunk: the rows in the bundle's
        dtype (a view where they have it)."""
        return (torch.as_tensor(chunk, dtype=self._dtype),)

    @classmethod
    def from_torch_checkpoint(cls, path: str, model: ConvVAE1D, device=None,
                              **kwargs) -> "VAEScorer":
        """Serve a reference-trained ``.pth`` directly
        (``models.torch_import.load_torch_checkpoint`` onto ``device``,
        CUDA unless given)."""
        from ocm_tpu_torch.models.torch_import import load_torch_checkpoint

        return cls(model, load_torch_checkpoint(path, model, device),
                   **kwargs)
