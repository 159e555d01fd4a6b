"""The port's VAE commands (``train-vae``, ``hpo``, ``export-torch`` and
``screen`` of VAE run dirs) against ``ocm_tpu``'s CLI.

JAX's random streams cannot be replayed in torch, so ``train-vae`` and
``hpo`` are held by their files and by the port's own determinism (the
trainer and sweep parity tests cover the training itself).  Run
directories cross both ways: an ``ocm_tpu`` run dir, its bundle upcast to
float64 and screened by both packages in float64, gives equal accepts and
statistics within 1e-8 of scale at every variant; the port's run dirs are
read by ``ocm_tpu``'s screen.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ocm_tpu import cli as jcli
from ocm_tpu.models import bundle as JB
from ocm_tpu_torch import cli as tcli
from torch_port_cli_util import read_json, screen_both, tiny_data

VAE_ARGS = ["--latent-dim", "4", "--conv-blocks", "2", "--n-filters", "4",
            "--hidden-fc", "16", "--batch-size", "16"]
VAE_VARIANTS = [["d2"], ["d2_q"], ["f"], ["full"], ["vaesimca"],
                ["f", "--pin-f-stats"]]


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    return tiny_data(tmp_path_factory.mktemp("data") / "tiny.npz")


def _upcast_bundle(run_dir):
    """Rewrite a JAX run dir's bundle with every float leaf in float64
    (flax keeps float32 weights beside float64 statistics), so that both
    packages screen it in float64."""
    model, bundle, _ = jcli._load_vae_dir(run_dir)
    JB.save_bundle(os.path.join(run_dir, jcli.BUNDLE_FILE),
                   jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                                if jnp.issubdtype(a.dtype, jnp.floating)
                                else a, bundle))


@pytest.fixture(scope="module")
def jax_vae_dirs(tiny_npz, tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_vae")
    dirs = {}
    for name, extra in (("single", ["--epochs", "3"]),
                        ("stacked", ["--epochs", "2", "--all-classes"])):
        out = str(root / name)
        assert jcli.main(["train-vae", "--data", tiny_npz, *VAE_ARGS,
                          *extra, "--out-dir", out]) == 0
        _upcast_bundle(out)
        dirs[name] = out
    return dirs


@pytest.fixture
def jax_f64_network(monkeypatch):
    """``ocm_tpu``'s CLI building its ConvVAE1D to compute in float64 (its
    flax default computes the network in float32 whatever the bundle),
    so that both packages screen the upcast run dir in float64."""
    from ocm_tpu.models.vae import ConvVAE1D

    build = jcli._build_vae

    def build_f64(arch):
        m = build(arch)
        return ConvVAE1D(**{f: getattr(m, f) for f in (
            "input_length", "latent_dim", "conv_blocks", "n_filters",
            "kernel_size", "hidden_fc", "dropout", "activation")},
            dtype=jnp.float64)

    monkeypatch.setattr(jcli, "_build_vae", build_f64)


@pytest.mark.parametrize("kind", ["single", "stacked"])
@pytest.mark.parametrize("variant", VAE_VARIANTS, ids="_".join)
def test_jax_vae_run_dir_screened_by_the_port(kind, variant, jax_vae_dirs,
                                              jax_f64_network, tiny_npz,
                                              tmp_path):
    screen_both(tiny_npz, jax_vae_dirs[kind], ["--variant", *variant],
                 tmp_path, rtol=1e-8)


@pytest.fixture(scope="module")
def port_vae_dirs(tiny_npz, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_vae")
    dirs = {}
    for name, extra in (("single", ["--epochs", "3", "--plots"]),
                        ("stacked", ["--epochs", "2", "--all-classes"])):
        out = str(root / name)
        assert tcli.main(["train-vae", "--platform", "cpu", "--data",
                          tiny_npz, *VAE_ARGS, *extra, "--out-dir",
                          out]) == 0
        dirs[name] = out
    return dirs


@pytest.mark.parametrize("kind", ["single", "stacked"])
def test_port_vae_run_dir_read_by_jax(kind, port_vae_dirs, tiny_npz,
                                      tmp_path):
    """``ocm_tpu``'s screen reads the port's run dir (accepts equal; flax
    computes part of it in float32)."""
    for variant in ("d2", "vaesimca"):
        jdir, tdir = screen_both(tiny_npz, port_vae_dirs[kind],
                                  ["--variant", variant], tmp_path,
                                  rtol=1e-5)


def test_train_vae_files_and_determinism(port_vae_dirs, tiny_npz, tmp_path):
    run = port_vae_dirs["single"]
    assert os.path.exists(os.path.join(run, "losses_c0.png"))
    assert read_json(run, "params.json")["arch"]["input_length"] == 64
    losses = read_json(run, "losses.json")
    assert len(losses["train_losses"]) == 3
    assert np.isfinite(losses["train_losses"]).all()
    metrics = read_json(run, "metrics.json")
    assert set(metrics) == {"d2", "d2_q", "f", "full", "vaesimca"}
    assert os.path.exists(os.path.join(run, tcli.VAESIMCA_FILE))
    again = str(tmp_path / "again")
    assert tcli.main(["train-vae", "--platform", "cpu", "--data", tiny_npz,
                      *VAE_ARGS, "--epochs", "3", "--out-dir", again]) == 0
    assert read_json(again, "losses.json") == losses
    assert read_json(again, "metrics.json") == metrics
    # the screen of the run dir reproduces the train-time metrics
    for variant in ("d2", "vaesimca"):
        out = str(tmp_path / variant)
        assert tcli.main(["screen", "--platform", "cpu", "--data", tiny_npz,
                          "--model-dir", run, "--variant", variant,
                          "--out-dir", out]) == 0
        assert read_json(out, "metrics.json")[variant] == pytest.approx(
            metrics[variant], abs=1e-12)
    with pytest.raises(SystemExit, match="pin-f-stats"):
        tcli.main(["screen", "--platform", "cpu", "--data", tiny_npz,
                   "--model-dir", run, "--variant", "d2", "--pin-f-stats",
                   "--out-dir", str(tmp_path / "bad")])


def test_train_vae_all_classes_and_export(port_vae_dirs, tiny_npz,
                                          tmp_path):
    import torch

    run = port_vae_dirs["stacked"]
    assert read_json(run, "params.json")["class_labels"] == [0, 1, 2]
    assert np.asarray(read_json(run, "losses.json")["train_losses"]).shape \
        == (3, 2)
    assert set(read_json(run, "metrics.json")["d2"]) == {"0", "1", "2"}
    with pytest.raises(SystemExit, match="--class-index"):
        tcli.main(["export-torch", "--platform", "cpu", "--model-dir", run,
                   "--out", str(tmp_path / "x.pth")])
    with pytest.raises(SystemExit, match="not in"):
        tcli.main(["export-torch", "--platform", "cpu", "--model-dir", run,
                   "--class-index", "7", "--out", str(tmp_path / "x.pth")])
    pth = str(tmp_path / "c1.pth")
    assert tcli.main(["export-torch", "--platform", "cpu", "--model-dir",
                      run, "--class-index", "1", "--out", pth]) == 0
    state = torch.load(pth, map_location="cpu", weights_only=True)
    assert "fc_mu.weight" in state and "threshold_q" in state
    # the reference's export of the same class of the same run dir
    jpth = str(tmp_path / "j1.pth")
    assert jcli.main(["export-torch", "--model-dir", run, "--class-index",
                      "1", "--out", jpth]) == 0
    ref = torch.load(jpth, map_location="cpu", weights_only=True)
    assert set(ref) == set(state)
    for k in ref:
        np.testing.assert_allclose(state[k].double().numpy(),
                                   ref[k].double().numpy(), rtol=0,
                                   atol=1e-12, err_msg=k)


def test_hpo_asha_files_and_determinism(tiny_npz, tmp_path):
    outs = []
    for i in range(2):
        out = str(tmp_path / f"hpo{i}")
        assert tcli.main(["hpo", "--platform", "cpu", "--data", tiny_npz,
                          "--algo", "asha", "--n-trials", "3",
                          "--max-epochs", "3", "--quiet",
                          "--out-dir", out]) == 0
        outs.append(out)
    p0, p1 = (read_json(o, "params.json") for o in outs)
    assert p0 == p1 and p0["algo"] == "asha" and p0["total_epochs"] > 0
    assert read_json(outs[0], "trials.json")["history"]
    assert os.path.exists(os.path.join(outs[0], tcli.BUNDLE_FILE))
    # the best trial's bundle serves in both packages
    screen_both(tiny_npz, outs[0], [], tmp_path, rtol=1e-5)


def test_hpo_tpe_with_space(tiny_npz, tmp_path):
    space = tmp_path / "space.json"
    space.write_text(json.dumps({"latent_dim": ["int", 3, 6],
                                 "lr": ["loguniform", 1e-4, 1e-2]}))
    out = str(tmp_path / "tpe")
    assert tcli.main(["hpo", "--platform", "cpu", "--data", tiny_npz,
                      "--algo", "tpe", "--n-trials", "2", "--max-epochs", "2",
                      "--space", str(space), "--quiet",
                      "--out-dir", out]) == 0
    assert 3 <= read_json(out, "params.json")["best_config"]["latent_dim"] <= 6
    assert len(read_json(out, "trials.json")["history"]) == 2


def test_int8_store_refused_on_a_vae_dir(port_vae_dirs, tiny_npz, tmp_path):
    with pytest.raises(SystemExit, match="int8"):
        tcli.main(["screen", "--platform", "cpu", "--data", tiny_npz,
                   "--model-dir", port_vae_dirs["single"], "--store-dtype",
                   "int8", "--out-dir", str(tmp_path / "s")])
