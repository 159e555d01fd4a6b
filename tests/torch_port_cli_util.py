"""Shared helpers of the CLI parity tests (``test_torch_port_cli*.py``):
run a command through both packages' ``cli.main`` and compare what they
write."""

import json
import os

import numpy as np

from ocm_tpu import cli as jcli
from ocm_tpu_torch import cli as tcli


def tiny_data(path):
    """``tests/test_cli.py``'s tiny 3-class dataset, written to ``path``."""
    from ocm_tpu.utils.synthetic import cheese_like

    x_tr, y_tr, x_ts, y_ts = cheese_like(seed=3, n_per_class=40, length=64,
                                         n_classes=3)
    np.savez(path, x_train=x_tr, y_train=y_tr, x_test=x_ts, y_test=y_ts)
    return str(path)


def read_json(run_dir, name):
    with open(os.path.join(run_dir, name)) as f:
        return json.load(f)


def preds(run_dir):
    z = np.load(os.path.join(run_dir, "predictions.npz"))
    return {k: z[k] for k in z.files}


def both(argv, tmp_path, name):
    """Run ``argv`` through both CLIs; returns (jax run dir, port run dir)."""
    jdir, tdir = str(tmp_path / f"j_{name}"), str(tmp_path / f"t_{name}")
    assert jcli.main(argv + ["--out-dir", jdir]) == 0
    assert tcli.main(argv + ["--platform", "cpu", "--out-dir", tdir]) == 0
    return jdir, tdir


def assert_tree_close(a, b, rtol=1e-8):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_tree_close(a[k], b[k], rtol)
    elif isinstance(a, list) and a and isinstance(a[0], (list, dict)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert_tree_close(u, v, rtol)
    elif isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_allclose(np.asarray(b, float), np.asarray(a, float),
                                   rtol=rtol, atol=1e-12)


def assert_preds_match(ref, got, rtol=1e-8):
    assert set(ref) == set(got)
    np.testing.assert_array_equal(got["accept"], ref["accept"])
    for k in ref:
        if k != "accept":
            scale = np.abs(ref[k].astype(np.float64)).max()
            np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                       atol=rtol * scale, err_msg=k)


def screen_both(data, model_dir, extra, tmp_path, rtol=1e-7):
    argv = ["screen", "--data", data, "--model-dir", model_dir] + extra
    jdir, tdir = both(argv, tmp_path, os.path.basename(model_dir)
                       + "_".join(extra))
    assert_preds_match(preds(jdir), preds(tdir), rtol)
    if os.path.exists(os.path.join(jdir, "metrics.json")):
        assert_tree_close(read_json(jdir, "metrics.json"),
                           read_json(tdir, "metrics.json"))
    return jdir, tdir
