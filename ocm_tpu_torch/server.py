"""HTTP scoring server: the deployment surface around the chunked scorers
(port of ``ocm_tpu/server.py``).

A dependency-free stdlib ``ThreadingHTTPServer`` around one loaded
:class:`ocm_tpu_torch.serving.SIMCAScorer` or
:class:`~ocm_tpu_torch.serving.VAEScorer`, resident on its device.

- Scoring is serialized under one device lock: requests may arrive
  concurrently, but the scorers enqueue on one CUDA stream.  Request
  parsing and response encoding run on the handler threads, outside it.
- Payloads: ``.npz`` bytes (key ``x``) for volume, or JSON ``{"x":
  [[...], ...]}``.  Responses mirror the request (JSON by default, npz
  when ``Accept: application/x-npz``).
- ``warmup()`` scores one dummy spectrum before traffic: on the card it
  pays the kernel library's first build (``ops._build.library``, nvcc)
  and launch, and cuBLAS/cuDNN's first-call set-up; there is no compile
  per chunk shape.
- Backpressure: at most ``max_queue`` requests hold or wait for the
  device lock; the rest get an immediate ``429``.
- Live reload: ``POST /reload`` swaps the resident scorer in place
  (optionally from another run dir), so a ``stream-fit`` refresh goes live
  without dropping the port.

Endpoints: ``GET /health``, ``GET /info``, ``POST /score``,
``POST /reload``.  CLI: ``python -m ocm_tpu_torch serve --model-dir <run
dir>``.  Standard library and numpy only.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

__all__ = ["ScoringServer"]


def _jsonable(out: dict) -> dict:
    """Decision dict -> JSON-safe (bool lists / float64 lists; handles
    bf16 arrays from quantized scorers)."""
    enc = {}
    for k, v in out.items():
        a = np.asarray(v)
        enc[k] = (a.tolist() if a.dtype == np.bool_
                  else a.astype(np.float64).tolist())
    return enc


class ScoringServer:
    """A resident scorer behind HTTP.

    Parameters
    ----------
    scorer : an object with ``.score(x) -> dict`` (SIMCAScorer/VAEScorer)
    info : metadata dict returned verbatim by ``GET /info``
    host, port : bind address; ``port=0`` picks a free port (see
        ``.port`` after construction)
    expected_length : if given, requests with a different spectral
        length are rejected with 400 instead of a shape error mid-score
    max_queue : bound on requests concurrently held for the device lock
        (in flight + waiting); excess requests get 429 immediately
    reload_fn : ``reload_fn(model_dir or None) -> (scorer, info,
        expected_length)``; enables ``POST /reload``.  ``None`` in the
        call means "reload from wherever the current model came from".
    """

    def __init__(self, scorer, info: Optional[dict] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 expected_length: Optional[int] = None,
                 max_queue: int = 8, reload_fn=None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.scorer = scorer
        self.info = dict(info or {})
        self.expected_length = expected_length
        self.max_queue = max_queue
        self._reload_fn = reload_fn
        self._lock = threading.Lock()
        # counts requests holding or waiting for the device lock; a
        # BoundedSemaphore is exactly that counter with overflow safety
        self._slots = threading.BoundedSemaphore(max_queue)
        self._count_lock = threading.Lock()
        self.n_scored = 0
        self.n_rejected = 0
        self.started = time.time()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, payload: bytes,
                       ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _reply_json(self, code: int, obj) -> None:
                self._reply(code, json.dumps(obj).encode())

            def do_GET(self):
                if self.path == "/health":
                    self._reply_json(200, {
                        "status": "ok",
                        "uptime_s": round(time.time() - outer.started, 3),
                        "n_scored": outer.n_scored,
                        "n_rejected": outer.n_rejected})
                elif self.path == "/info":
                    self._reply_json(200, outer.info)
                else:
                    self._reply_json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path == "/reload":
                    code, obj = outer._handle_reload(
                        self.rfile.read(
                            int(self.headers.get("Content-Length", 0))))
                    self._reply_json(code, obj)
                    return
                if self.path != "/score":
                    self._reply_json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    x = outer._parse(self.rfile.read(n),
                                     self.headers.get("Content-Type", ""))
                except ValueError as e:
                    self._reply_json(400, {"error": str(e)})
                    return
                if not outer._slots.acquire(blocking=False):
                    with outer._count_lock:
                        outer.n_rejected += 1
                    self._reply_json(429, {
                        "error": f"queue full ({outer.max_queue} requests "
                                 "in flight); retry with backoff"})
                    return
                try:
                    with outer._lock:      # one device stream
                        out = outer.scorer.score(x)
                        outer.n_scored += len(x)
                except Exception as e:   # surface scoring failures as 500
                    self._reply_json(500, {"error":
                                           f"{type(e).__name__}: {e}"})
                    return
                finally:
                    outer._slots.release()
                if "application/x-npz" in self.headers.get("Accept", ""):
                    buf = io.BytesIO()
                    np.savez(buf, **{k: np.asarray(v)
                                     for k, v in out.items()})
                    self._reply(200, buf.getvalue(), "application/x-npz")
                else:
                    self._reply_json(200, _jsonable(out))

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ parse

    def _parse(self, body: bytes, ctype: str) -> np.ndarray:
        if not body:
            raise ValueError("empty request body")
        if "json" in ctype:
            try:
                x = np.asarray(json.loads(body)["x"], np.float32)
            except (json.JSONDecodeError, KeyError, TypeError) as e:
                raise ValueError(f"bad JSON payload (want {{'x': "
                                 f"[[...]]}}): {e}") from e
        else:
            try:
                z = np.load(io.BytesIO(body))
            except Exception as e:
                raise ValueError(f"body is neither npz nor JSON: {e}") \
                    from e
            with z:
                if "x" not in z:
                    raise ValueError(f"npz payload needs key 'x', has "
                                     f"{sorted(z.files)}")
                x = np.asarray(z["x"], np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2:
            raise ValueError(f"x must be (N, L), got shape {x.shape}")
        if (self.expected_length is not None
                and x.shape[1] != self.expected_length):
            raise ValueError(f"model expects L={self.expected_length} "
                             f"spectra, got L={x.shape[1]}")
        return x

    # ------------------------------------------------------------ reload

    def _handle_reload(self, body: bytes):
        """POST /reload: rebuild the scorer via ``reload_fn`` and swap it
        under the device lock, so a ``stream-fit`` refresh (or a whole new
        run dir) goes live without dropping the port.  In-flight requests
        finish on the old scorer; requests arriving during the swap wait.
        Returns (status_code, json_payload)."""
        if self._reload_fn is None:
            return 501, {"error": "server started without reload_fn; "
                                  "restart to change models"}
        model_dir = None
        if body:
            try:
                req = json.loads(body)
                model_dir = req.get("model_dir")
            except (json.JSONDecodeError, AttributeError) as e:
                return 400, {"error": f"bad JSON (want {{'model_dir': "
                                      f"...}} or empty): {e}"}
        try:
            scorer, info, length = self._reload_fn(model_dir)
        except (Exception, SystemExit) as e:
            # SystemExit included: the CLI-built reload_fn surfaces user
            # errors (bad --model-dir, int8 on a VAE dir) as SystemExit,
            # which is a BaseException and would otherwise escape, kill
            # the handler thread, and reset the connection.
            # the OLD scorer keeps serving — a failed reload must not
            # take the service down
            return 500, {"error": f"reload failed, still serving the "
                                  f"previous model: "
                                  f"{type(e).__name__}: {e}"}
        with self._lock:
            self.scorer = scorer
            self.info = dict(info or {})
            self.expected_length = length
        self.warmup()
        return 200, {"status": "reloaded", "info": self.info}

    # -------------------------------------------------------- lifecycle

    def warmup(self) -> None:
        """Score one dummy spectrum before serving traffic (the kernel
        library's first build and launch on the card).  Takes the request
        lock: the listening socket exists from construction, so a request
        can already be in flight while warmup runs."""
        length = self.expected_length or self.info.get("input_length")
        if length:
            with self._lock:
                self.scorer.score(np.zeros((1, int(length)), np.float32))

    def start(self) -> "ScoringServer":
        """Serve on a daemon thread (returns immediately; see ``.port``)."""
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Blocking serve (the CLI path)."""
        self._server.serve_forever()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
