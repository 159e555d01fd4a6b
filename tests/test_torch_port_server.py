"""The port's HTTP scoring server (``ocm_tpu_torch/server.py``) against
``ocm_tpu``'s: the twelve behaviours of ``tests/test_server.py`` on the
port's server over the port's scorers on the CPU, and run directories
written by ``ocm_tpu`` (a stacked SIMCA model, a VAE bundle) served by
both servers, whose JSON answers agree: equal accepts, statistics within
1e-8 of scale (SIMCA's 1e-6: ``ocm_tpu`` expands Q against a float32
norm of the chunk)."""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ocm_tpu import cli as jcli
from ocm_tpu.server import ScoringServer as JServer
from ocm_tpu.utils.synthetic import cheese_like
from ocm_tpu_torch import cli as tcli
from ocm_tpu_torch.models.simca import fit_classes, fit_simca
from ocm_tpu_torch.server import ScoringServer
from ocm_tpu_torch.serving import SIMCAScorer

L = 48


@pytest.fixture(scope="module")
def data():
    return cheese_like(seed=11, n_per_class=50, length=L, n_classes=3)


@pytest.fixture(scope="module")
def server(data):
    x_tr, y_tr, _, _ = data
    model = fit_classes(x_tr, y_tr, [0, 1, 2], n_components=5, device="cpu")
    scorer = SIMCAScorer(model, chunk_size=64)
    srv = ScoringServer(scorer, info={"kind": "simca",
                                      "class_labels": [0, 1, 2],
                                      "input_length": L},
                        expected_length=L).start()
    yield srv, scorer
    srv.stop()


def _url(srv, path):
    return f"http://{srv.host}:{srv.port}{path}"


def _post(srv, body, ctype, accept=None, path="/score"):
    req = urllib.request.Request(_url(srv, path), data=body,
                                 headers={"Content-Type": ctype,
                                          **({"Accept": accept}
                                             if accept else {})})
    return urllib.request.urlopen(req, timeout=60)


def _post_json(srv, x):
    with _post(srv, json.dumps({"x": np.asarray(x).tolist()}).encode(),
               "application/json") as r:
        return json.loads(r.read())


def test_health_and_info(server):
    srv, _ = server
    with urllib.request.urlopen(_url(srv, "/health"), timeout=30) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["uptime_s"] >= 0
    with urllib.request.urlopen(_url(srv, "/info"), timeout=30) as r:
        assert json.loads(r.read())["class_labels"] == [0, 1, 2]


def test_score_json_parity(server, data):
    srv, scorer = server
    x = np.asarray(data[2][:20], np.float32)
    out = _post_json(srv, x)
    direct = scorer.score(x)
    np.testing.assert_array_equal(np.asarray(out["accept"]),
                                  direct["accept"])
    np.testing.assert_allclose(np.asarray(out["dred"]),
                               np.asarray(direct["dred"], np.float64),
                               rtol=1e-12)


def test_score_npz_roundtrip(server, data):
    srv, scorer = server
    x = np.asarray(data[2][:33], np.float32)
    buf = io.BytesIO()
    np.savez(buf, x=x)
    with _post(srv, buf.getvalue(), "application/x-npz",
               accept="application/x-npz") as r:
        assert r.headers["Content-Type"] == "application/x-npz"
        out = np.load(io.BytesIO(r.read()))
    direct = scorer.score(x)
    for k in direct:
        np.testing.assert_array_equal(out[k], direct[k])
    assert out["accept"].shape == (33, 3)


def test_single_spectrum_promoted(server, data):
    srv, _ = server
    out = _post_json(srv, np.asarray(data[2][0]))
    assert np.asarray(out["accept"]).shape == (1, 3)


@pytest.mark.parametrize("body,ctype,msg", [
    (b"", "application/json", "empty request body"),
    (b"{\"y\": []}", "application/json", "bad JSON"),
    (b"garbage-bytes", "application/octet-stream", "neither npz"),
    (b"{\"x\": [[[1.0]]]}", "application/json", "must be (N, L)"),
])
def test_bad_payloads_400(server, body, ctype, msg):
    srv, _ = server
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(srv, body, ctype)
    assert exc.value.code == 400
    assert msg in json.loads(exc.value.read())["error"]


def test_npz_without_x_400(server):
    srv, _ = server
    buf = io.BytesIO()
    np.savez(buf, y=np.zeros((2, L)))
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(srv, buf.getvalue(), "application/x-npz")
    assert exc.value.code == 400
    assert "needs key 'x'" in json.loads(exc.value.read())["error"]


def test_wrong_length_400_and_route_404(server):
    srv, _ = server
    body = json.dumps({"x": [[0.0] * (L + 1)]}).encode()
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(srv, body, "application/json")
    assert exc.value.code == 400
    assert f"expects L={L}" in json.loads(exc.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(_url(srv, "/nope"), timeout=30)
    assert exc.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(srv, body, "application/json", path="/nope")
    assert exc.value.code == 404


def test_concurrent_posts_serialize(server, data):
    srv, scorer = server
    x = np.asarray(data[2][:16], np.float32)
    expected = scorer.score(x)["accept"]
    before = srv.n_scored
    results, errors = [None] * 8, []

    def worker(i):
        try:
            results[i] = np.asarray(_post_json(srv, x)["accept"])
        except Exception as e:  # surfaced in the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    for r in results:
        np.testing.assert_array_equal(r, expected)
    assert srv.n_scored - before == 8 * 16


def test_scorer_failure_returns_500():
    class Boom:
        def score(self, x):
            raise RuntimeError("device fell over")

    srv = ScoringServer(Boom(), info={}).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post_json(srv, [[1.0, 2.0]])
        assert exc.value.code == 500
        err = json.loads(exc.value.read())["error"]
        assert "RuntimeError" in err and "device fell over" in err
    finally:
        srv.stop()


def test_max_queue_must_be_positive():
    with pytest.raises(ValueError, match="max_queue"):
        ScoringServer(object(), max_queue=0)


def test_build_scorer_run_dir_and_warmup(tmp_path, data):
    """cli._build_scorer -> ScoringServer over a run dir (the serve
    command's wiring): warmup scores one dummy spectrum."""
    x_tr, y_tr, x_ts, _ = data
    model = fit_simca(x_tr[y_tr == 0], 5, device="cpu")
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    tcli._save_simca_model(run_dir, model,
                           {"kind": "simca", "stacked": False,
                            "class_labels": [0], "decision_type": "alt",
                            "n_components": 5, "t2lim": "Fdist",
                            "qlim": "jm"})
    scorer, info = tcli._build_scorer(run_dir, chunk_size=64, device="cpu")
    assert info["kind"] == "simca" and info["input_length"] == L

    calls = []

    class Counting:
        def score(self, x):
            calls.append(x.shape)
            return scorer.score(x)

    srv = ScoringServer(Counting(), info,
                        expected_length=info["input_length"]).start()
    try:
        srv.warmup()
        assert calls == [(1, L)]
        out = _post_json(srv, x_ts[:5])
        assert len(out["accept"]) == 5
    finally:
        srv.stop()


def test_queue_overflow_429():
    gate, started = threading.Event(), threading.Event()

    class Slow:
        def score(self, x):
            started.set()
            assert gate.wait(timeout=60)
            return {"accept": np.ones(len(x), bool)}

    srv = ScoringServer(Slow(), info={}, max_queue=2).start()
    body = json.dumps({"x": [[1.0, 2.0]]}).encode()
    codes, lock = [], threading.Lock()

    def worker():
        try:
            with _post(srv, body, "application/json") as r:
                with lock:
                    codes.append(r.status)
        except urllib.error.HTTPError as e:
            with lock:
                codes.append(e.code)
            e.close()

    try:
        threads = [threading.Thread(target=worker) for _ in range(3)]
        threads[0].start()
        assert started.wait(timeout=30)
        threads[1].start()
        deadline = time.time() + 30
        threads[2].start()
        while time.time() < deadline:
            with lock:
                if 429 in codes:
                    break
            time.sleep(0.02)
        gate.set()
        for t in threads:
            t.join(timeout=60)
        assert sorted(codes) == [200, 200, 429], codes
        assert srv.n_rejected == 1
        with _post(srv, body, "application/json") as r:
            assert r.status == 200
    finally:
        gate.set()
        srv.stop()


def test_reload_endpoint_swaps_scorer():
    class Const:
        def __init__(self, v):
            self.v = v

        def score(self, x):
            return {"accept": np.full(len(x), self.v, bool)}

    calls = []

    def reload_fn(model_dir):
        calls.append(model_dir)
        if model_dir == "broken":
            raise FileNotFoundError("no such run dir")
        return Const(False), {"kind": "v2", "input_length": 2}, 2

    srv = ScoringServer(Const(True), info={"kind": "v1"},
                        reload_fn=reload_fn).start()
    try:
        assert _post_json(srv, [[1.0, 2.0]])["accept"] == [True]
        with _post(srv, b"", "application/json", path="/reload") as r:
            out = json.loads(r.read())
        assert out["status"] == "reloaded" and out["info"]["kind"] == "v2"
        assert calls == [None]
        assert _post_json(srv, [[1.0, 2.0]])["accept"] == [False]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv, json.dumps({"model_dir": "broken"}).encode(),
                  "application/json", path="/reload")
        assert exc.value.code == 500
        assert "still serving" in json.loads(exc.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv, b"[not json", "application/json", path="/reload")
        assert exc.value.code == 400
        assert _post_json(srv, [[1.0, 2.0]])["accept"] == [False]
    finally:
        srv.stop()

    srv2 = ScoringServer(Const(True), info={}).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv2, b"", "application/json", path="/reload")
        assert exc.value.code == 501
    finally:
        srv2.stop()


def test_reload_cli_systemexit_returns_500(tmp_path, data):
    """The serve command's reload_fn, pointed at a dir that is not a run
    dir, raises SystemExit inside the handler: a 500, the old model kept."""
    x_tr, y_tr, _, _ = data
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    tcli._save_simca_model(run_dir, fit_simca(x_tr[y_tr == 0], 3,
                                              device="cpu"),
                           {"kind": "simca", "stacked": False,
                            "class_labels": [0], "decision_type": "alt",
                            "n_components": 3})
    args = tcli.build_parser().parse_args(
        ["serve", "--model-dir", run_dir, "--port", "0", "--chunk-size",
         "256", "--platform", "cpu"])
    args.device = "cpu"
    srv = tcli.make_server(args).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv, json.dumps({"model_dir": str(tmp_path / "nope")})
                  .encode(), "application/json", path="/reload")
        assert exc.value.code == 500
        assert "still serving" in json.loads(exc.value.read())["error"]
        assert len(_post_json(srv, x_tr[:2])["accept"]) == 2
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def jax_run_dirs(data, tmp_path_factory):
    """An ``ocm_tpu`` stacked SIMCA run dir and a VAE run dir with every
    float leaf of its bundle in float64."""
    from ocm_tpu.models import bundle as JB

    x_tr, y_tr, x_ts, y_ts = data
    root = tmp_path_factory.mktemp("jax_runs")
    npz = str(root / "d.npz")
    np.savez(npz, x_train=x_tr, y_train=y_tr, x_test=x_ts, y_test=y_ts)
    simca_dir, vae_dir = str(root / "simca"), str(root / "vae")
    assert jcli.main(["simca", "--data", npz, "--all-classes",
                      "--n-components", "5", "--out-dir", simca_dir]) == 0
    assert jcli.main(["train-vae", "--data", npz, "--epochs", "2",
                      "--latent-dim", "4", "--conv-blocks", "2",
                      "--n-filters", "4", "--hidden-fc", "16",
                      "--batch-size", "16", "--out-dir", vae_dir]) == 0
    model, bundle, _ = jcli._load_vae_dir(vae_dir)
    JB.save_bundle(os.path.join(vae_dir, jcli.BUNDLE_FILE),
                   jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                                if jnp.issubdtype(a.dtype, jnp.floating)
                                else a, bundle))
    return {"simca": simca_dir, "vae": vae_dir}


@pytest.mark.parametrize("kind,variant", [("simca", "d2"), ("vae", "d2"),
                                          ("vae", "vaesimca")])
def test_jax_run_dirs_served_by_both(kind, variant, jax_run_dirs, data,
                                     monkeypatch):
    from ocm_tpu.models.vae import ConvVAE1D

    build = jcli._build_vae
    # ocm_tpu's network in float64 (its flax default computes in float32)
    monkeypatch.setattr(jcli, "_build_vae", lambda arch: ConvVAE1D(
        **{f: getattr(build(arch), f) for f in (
            "input_length", "latent_dim", "conv_blocks", "n_filters",
            "kernel_size", "hidden_fc", "dropout", "activation")},
        dtype=jnp.float64))
    run_dir = jax_run_dirs[kind]
    js, jinfo = jcli._build_scorer(run_dir, 64, None, variant)
    ts, tinfo = tcli._build_scorer(run_dir, 64, None, variant,
                                   device="cpu")
    assert jinfo == tinfo
    x = data[2][:40]
    outs = []
    for cls, scorer in ((JServer, js), (ScoringServer, ts)):
        srv = cls(scorer, jinfo,
                  expected_length=jinfo["input_length"]).start()
        try:
            outs.append(_post_json(srv, x))
        finally:
            srv.stop()
    ref, got = outs
    assert set(ref) == set(got)
    np.testing.assert_array_equal(got["accept"], ref["accept"])
    # ocm_tpu's SIMCA scorer expands Q against a float32 ||x||^2 of the
    # chunk (ocm_tpu/serving.py:401); the port forms ||x - m||^2 directly
    tol = 1e-6 if kind == "simca" else 1e-8
    for k in ref:
        if k != "accept":
            a = np.asarray(ref[k])
            np.testing.assert_allclose(np.asarray(got[k]), a, rtol=0,
                                       atol=tol * np.abs(a).max(),
                                       err_msg=k)
