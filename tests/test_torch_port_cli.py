"""The port's CLI (``python -m ocm_tpu_torch``) against ``ocm_tpu``'s.

The same commands run through both packages' ``cli.main`` on the same tiny
3-class dataset (``tests/test_cli.py``'s), the port's with ``--platform
cpu`` (float64 there, as JAX's x64): the deterministic SIMCA commands give
equal ``metrics.json`` (1e-8) and equal accepts, and SIMCA run directories
and statistic files written by either package are read by the other.  The
VAE commands are in ``test_torch_port_cli_vae.py``.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest

from ocm_tpu import cli as jcli
from ocm_tpu_torch import cli as tcli
from torch_port_cli_util import (assert_tree_close, both, preds, read_json,
                                 screen_both, tiny_data)


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    return tiny_data(tmp_path_factory.mktemp("data") / "tiny.npz")


SIMCA_COMMANDS = {
    "simca": ["simca", "--n-components", "5", "--quiet"],
    "simca_all": ["simca", "--all-classes", "--n-components", "5"],
    "simca_all_rsvd": ["simca", "--all-classes", "--n-components", "5",
                       "--solver", "rsvd"],
    "simca_all_dd": ["simca", "--all-classes", "--type", "dd",
                     "--n-components", "5"],
    "simca_unequal_outliers": ["simca", "--all-classes", "--n-components",
                               "5", "--remove-outliers",
                               "--outlier-components", "4"],
    "plsda": ["plsda", "--max-components", "6", "--n-folds", "3"],
}


@pytest.mark.parametrize("name", sorted(SIMCA_COMMANDS))
def test_simca_commands_match_reference(name, tiny_npz, tmp_path):
    jdir, tdir = both(SIMCA_COMMANDS[name] + ["--data", tiny_npz],
                       tmp_path, name)
    assert_tree_close(read_json(jdir, "metrics.json"),
                       read_json(tdir, "metrics.json"))
    if name == "plsda":
        assert_tree_close(read_json(jdir, "cv.json"),
                          read_json(tdir, "cv.json"))
    else:
        assert (read_json(jdir, tcli.SIMCA_META_JSON)
                == read_json(tdir, tcli.SIMCA_META_JSON))


def test_cv_refit_matches_reference(tiny_npz, tmp_path):
    argv = ["cv", "--data", tiny_npz, "--lv-min", "2", "--lv-max", "4",
            "--n-splits", "3", "--refit"]
    jdir, tdir = both(argv, tmp_path, "cv")
    assert_tree_close(read_json(jdir, "cv.json"), read_json(tdir, "cv.json"))
    assert (read_json(jdir, tcli.SIMCA_META_JSON)
            == read_json(tdir, tcli.SIMCA_META_JSON))
    # each package screens both refit models to the same accepts
    for run in (jdir, tdir):
        screen_both(tiny_npz, run, [], tmp_path)


@pytest.fixture(scope="module")
def simca_dirs(tiny_npz, tmp_path_factory):
    """SIMCA run dirs written by each package: single, stacked, and a
    two-chunk streamed statistic fitted by stream-fit."""
    root = tmp_path_factory.mktemp("simca_dirs")
    dirs = {}
    for tag, main, plat in (("j", jcli.main, []),
                            ("t", tcli.main, ["--platform", "cpu"])):
        for name, argv in (("single", SIMCA_COMMANDS["simca"]),
                           ("stacked", SIMCA_COMMANDS["simca_all"])):
            out = str(root / f"{tag}_{name}")
            assert main(argv + ["--data", tiny_npz, "--out-dir", out]
                        + plat) == 0
            dirs[tag, name] = out
        mom = str(root / f"{tag}_mom.msgpack")
        for split in ("train", "test"):
            assert main(["stream-update", "--data", tiny_npz, "--moments",
                         mom, "--split", split, "--target-class", "0"]
                        + plat) == 0
        out = str(root / f"{tag}_stream")
        assert main(["stream-fit", "--moments", mom, "--n-components", "5",
                     "--out-dir", out] + plat) == 0
        dirs[tag, "stream"] = out
        dirs[tag, "moments"] = mom
    return dirs


@pytest.mark.parametrize("writer", ["j", "t"])
@pytest.mark.parametrize("kind", ["single", "stacked", "stream"])
@pytest.mark.parametrize("store", [[], ["--store-dtype", "int8"]],
                         ids=["f32", "int8"])
def test_simca_run_dirs_cross_read(writer, kind, store, simca_dirs,
                                   tiny_npz, tmp_path):
    """Every SIMCA run dir, written by either package, screens to equal
    accepts and metrics in both (f32 chunks and int8 residuals)."""
    screen_both(tiny_npz, simca_dirs[writer, kind], store, tmp_path,
                 rtol=2e-6)


def test_bf16_screen_against_the_ports_f32(simca_dirs, tiny_npz, tmp_path):
    """bf16 residuals through K1's half-width read: the port's bf16
    screen agrees with its own f32 screen; the JAX package's bf16 scorer
    is a different design (bf16 loadings, ROADMAP.md queue 3)."""
    outs = {}
    for extra in ([], ["--store-dtype", "bf16"]):
        out = str(tmp_path / ("s" + "".join(extra)))
        assert tcli.main(["screen", "--platform", "cpu", "--data", tiny_npz,
                          "--model-dir", simca_dirs["j", "stacked"],
                          "--out-dir", out] + extra) == 0
        outs[len(extra)] = preds(out)
    f32, bf16 = outs[0], outs[2]
    assert (f32["accept"] == bf16["accept"]).mean() >= 0.99
    np.testing.assert_allclose(bf16["dred"], f32["dred"], rtol=0.05)


@pytest.mark.parametrize("writer", ["j", "t"])
@pytest.mark.parametrize("kind", ["single", "stacked", "stream"])
def test_bf16_screen_against_reference_f32(writer, kind, simca_dirs,
                                           tiny_npz, tmp_path):
    """The port's bf16 screen of a run dir held against ``ocm_tpu``'s
    f32 screen of the same run dir and data, at the reduced-width
    contract: accepts >= 99.5 % equal, dred within 3e-2 of its max."""
    run_dir = simca_dirs[writer, kind]
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    argv = ["screen", "--data", tiny_npz, "--model-dir", run_dir]
    assert jcli.main(argv + ["--out-dir", jdir]) == 0
    assert tcli.main(argv + ["--store-dtype", "bf16", "--platform", "cpu",
                             "--out-dir", tdir]) == 0
    ref, got = preds(jdir), preds(tdir)
    assert got["accept"].shape == ref["accept"].shape
    assert (got["accept"] == ref["accept"]).mean() >= 0.995
    assert (np.abs(got["dred"] - ref["dred"]).max()
            <= 3e-2 * np.abs(ref["dred"]).max())


def test_stream_moments_files_cross_read(simca_dirs, tiny_npz, tmp_path):
    """A statistic file written by either package takes the other's next
    chunk and stream-fit, with the same model."""
    outs = {}
    for tag, main, plat in (("j", jcli.main, []),
                            ("t", tcli.main, ["--platform", "cpu"])):
        other = "t" if tag == "j" else "j"
        mom = str(tmp_path / f"{tag}.msgpack")
        with open(simca_dirs[other, "moments"], "rb") as f, \
                open(mom, "wb") as g:
            g.write(f.read())
        assert main(["stream-update", "--data", tiny_npz, "--moments", mom,
                     "--split", "test", "--target-class", "1"] + plat) == 0
        outs[tag] = str(tmp_path / f"fit_{tag}")
        assert main(["stream-fit", "--moments", mom, "--n-components", "4",
                     "--out-dir", outs[tag]] + plat) == 0
    from ocm_tpu_torch.models.simca import load_simca_model

    a, b = (load_simca_model(os.path.join(outs[t], tcli.SIMCA_MODEL_FILE),
                             "cpu") for t in ("j", "t"))
    np.testing.assert_allclose(a.mean.numpy(), b.mean.numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(a.d_limit), float(b.d_limit), rtol=1e-5)


def test_load_dataset_npz_forms(tmp_path):
    x = np.random.default_rng(0).normal(size=(50, 16))
    y = np.repeat([0, 1], 25)
    p_xy = tmp_path / "xy.npz"
    np.savez(p_xy, x=x, y=y)
    for got, ref in zip(tcli.load_dataset(str(p_xy), seed=0),
                        jcli.load_dataset(str(p_xy), seed=0)):
        np.testing.assert_array_equal(got, ref)
    p_bad = tmp_path / "bad.npz"
    np.savez(p_bad, foo=x)
    with pytest.raises(ValueError, match="expected keys"):
        tcli.load_dataset(str(p_bad))
    p_half = tmp_path / "half.npz"
    np.savez(p_half, x_train=x, y_train=y)
    with pytest.raises(ValueError, match="missing"):
        tcli.load_dataset(str(p_half))
    with pytest.raises(ValueError, match="unsupported data file"):
        tcli.load_dataset("data.csv")
    for got, ref in zip(tcli.load_dataset(None, "nuts", seed=1),
                        jcli.load_dataset(None, "nuts", seed=1)):
        np.testing.assert_array_equal(got, ref)


def test_no_prefix_abbreviation():
    p = tcli.build_parser()
    for argv in (["simca", "--out", "x"], ["cv", "--lv", "3"],
                 ["train-vae", "--epoch", "2"],
                 ["screen", "--model", "m", "--model-dir", "d"]):
        with pytest.raises(SystemExit):
            p.parse_args(argv)


def test_platform_accepted_after_subcommand():
    p = tcli.build_parser()
    assert p.parse_args(["simca", "--platform", "cpu"]).platform == "cpu"
    assert p.parse_args(["--platform", "cpu", "simca"]).platform == "cpu"
    assert p.parse_args(["--platform", "cpu", "screen", "--model-dir",
                         "m"]).platform == "cpu"
    assert p.parse_args(["--platform", "cuda", "simca", "--platform",
                         "cpu"]).platform == "cpu"
    assert p.parse_args(["simca"]).platform is None
    with pytest.raises(SystemExit):
        p.parse_args(["simca", "--platform", "tpu"])


def test_commands_and_flags_match_reference():
    """All twelve commands with the reference's flags and defaults, bar
    --platform's choices."""
    def actions(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {name: {a.dest: (a.default, a.choices and list(a.choices))
                       for a in sp._actions
                       if a.dest not in ("help", "platform")}
                for name, sp in sub.choices.items()}

    assert actions(tcli.build_parser()) == actions(jcli.build_parser())
    assert set(tcli.COMMANDS) == set(jcli.COMMANDS)
    assert len(tcli.COMMANDS) == 12


def test_default_platform_needs_cuda(tiny_npz, tmp_path):
    """No --platform means CUDA: without a card the command raises and
    never runs on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["simca", "--data", tiny_npz, "--quiet",
                   "--out-dir", str(tmp_path / "s")])
    assert not os.path.exists(tmp_path / "s" / "metrics.json")


def test_screen_error_surfaces(tiny_npz, tmp_path):
    with pytest.raises(SystemExit):
        tcli.main(["screen", "--platform", "cpu", "--data", tiny_npz,
                   "--model-dir", str(tmp_path / "nope"),
                   "--out-dir", str(tmp_path / "s")])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit):
        tcli.main(["screen", "--platform", "cpu", "--data", tiny_npz,
                   "--model-dir", str(empty), "--out-dir",
                   str(tmp_path / "s2")])


def test_class_split_and_binary_labels():
    x = np.zeros((10, 8))
    y = np.array([0] * 7 + [1] * 3)
    with pytest.raises(ValueError, match="class 1 has 3 samples"):
        tcli._class_split(x, y, 1)
    with pytest.raises(ValueError, match="class 2 has 0 samples"):
        tcli._class_split(x, y, 2)
    y = np.array([0, 1, 2, 3, 4, 3, 0])
    np.testing.assert_array_equal(tcli._binary_labels(y, 3),
                                  jcli._binary_labels(y, 3))


def test_remove_outliers_matches_reference(tiny_npz, tmp_path):
    import torch

    z = np.load(tiny_npz)
    x_tr, y_tr = np.array(z["x_train"]), np.asarray(z["y_train"])
    x_tr[np.where(y_tr == 0)[0][:2]] += 40.0
    argv = ["simca", "--remove-outliers", "--out-dir", str(tmp_path)]
    targs = tcli.build_parser().parse_args(argv)
    targs.device = torch.device("cpu")
    xt, yt = tcli._remove_outliers(targs, x_tr, y_tr)
    xj, yj = jcli._remove_outliers(jcli.build_parser().parse_args(argv),
                                   x_tr, y_tr)
    assert len(xt) < len(x_tr)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)


def test_ingest_store_feeds_simca(tmp_path):
    pytest.importorskip("h5py")
    out = str(tmp_path / "store.h5")
    assert tcli.main(["ingest", "--images-per-class", "1", "--out",
                      out]) == 0
    from ocm_tpu.utils.io import read_object_store

    data = read_object_store(out)
    assert len(data) == 5
    for got, ref in zip(tcli.load_dataset(out, seed=1),
                        jcli.load_dataset(out, seed=1)):
        np.testing.assert_array_equal(got, ref)
    fit = str(tmp_path / "fit")
    assert tcli.main(["simca", "--platform", "cpu", "--data", out,
                      "--n-components", "4", "--quiet",
                      "--out-dir", fit]) == 0
    assert "sensitivity" in read_json(fit, "metrics.json")["0"]


def test_plots_and_info(tiny_npz, tmp_path):
    pytest.importorskip("matplotlib")
    for argv, png in ((["cv", "--lv-min", "2", "--lv-max", "3",
                        "--n-splits", "3", "--plots"], "cv.png"),
                      (["plsda", "--max-components", "4", "--n-folds", "3",
                        "--plots"], "plsda_f1.png"),
                      (["simca", "--n-components", "4", "--quiet",
                        "--plots"], "t2q_train.png")):
        out = str(tmp_path / png)
        assert tcli.main(argv + ["--platform", "cpu", "--data", tiny_npz,
                                 "--out-dir", out]) == 0
        assert os.path.exists(os.path.join(out, png))
    r = subprocess.run([sys.executable, "-m", "ocm_tpu_torch", "info"],
                       capture_output=True, text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr
    assert "torch" in r.stdout and "tf32: matmul=False cudnn=False" \
        in r.stdout and "jax" not in r.stdout
