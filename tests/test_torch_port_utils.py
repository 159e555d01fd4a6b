"""The port's checkpoints, profiling and plots (``ocm_tpu_torch.utils.
checkpoint``, ``utils.profiling``, ``utils.report``), on the CPU.

- a training run resumed through ``TrainCheckpointer`` (2 epochs, save,
  restore in a fresh checkpointer, 2 more) equals 4 uninterrupted epochs
  bit for bit; ``max_to_keep`` deletes the oldest epochs; ``save_pytree``
  round-trips a ``state_dict`` (the msgpack format of the model files);
- ``timeit`` and ``EpochLogger`` behave as ``tests/test_profiling_f32.py``
  pins the JAX package's; ``trace`` writes a Chrome trace holding the
  ``annotate`` ranges; ``debug_nans`` traps a NaN gradient;
- each plot writes a file under matplotlib's Agg backend from numpy
  arrays or tensors, and the plotly twin raises a clean ImportError
  without plotly.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from ocm_tpu_torch.models.trainer import TrainConfig, train_vae
from ocm_tpu_torch.models.vae import ConvVAE1D
from ocm_tpu_torch.utils import checkpoint as CK
from ocm_tpu_torch.utils import msgpack_io, profiling, report

VAE = dict(input_length=48, latent_dim=4, conv_blocks=2, n_filters=8,
           hidden_fc=32)


def _spectra(rng, n, length=48):
    t = np.linspace(0, 1, length)
    return (rng.normal(1, 0.05, (n, 1)) * np.sin(2 * np.pi * 3 * t)
            + rng.normal(0, 0.02, (n, length))).astype(np.float32)


def _states_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


def test_resume_through_checkpointer_equals_uninterrupted(tmp_path):
    rng = np.random.default_rng(0)
    x_cal, x_val = _spectra(rng, 64), _spectra(rng, 24)
    torch.manual_seed(0)
    init = ConvVAE1D(**VAE)
    cfg = TrainConfig(epochs=2, batch_size=32, lr=2e-3, loss_type="euclidean")

    full = train_vae(copy.deepcopy(init), x_cal, x_val,
                     TrainConfig(epochs=4, batch_size=32, lr=2e-3,
                                 loss_type="euclidean"), seed=3, device="cpu")
    part1 = train_vae(copy.deepcopy(init), x_cal, x_val, cfg, seed=3,
                      device="cpu")
    ckpt = CK.TrainCheckpointer(str(tmp_path / "mgr"), max_to_keep=2)
    ckpt.save(2, part1.final_state, part1.final_opt_state)
    ckpt.close()

    fresh = CK.TrainCheckpointer(str(tmp_path / "mgr"))
    assert fresh.latest_epoch() == 2
    state, opt_state, epoch = fresh.restore()
    assert epoch == 2
    _states_equal(state, part1.final_state)
    part2 = train_vae(ConvVAE1D(**VAE), x_cal, x_val, cfg, seed=3,
                      init_state=(state, opt_state), epoch_offset=epoch,
                      device="cpu")
    np.testing.assert_array_equal(
        np.concatenate([part1.train_losses, part2.train_losses]),
        full.train_losses)
    np.testing.assert_array_equal(
        np.concatenate([part1.val_losses, part2.val_losses]),
        full.val_losses)
    _states_equal(part2.final_state, full.final_state)
    # the template form: the state in the model's dtypes and device
    state_t, _, _ = fresh.restore(model_template=ConvVAE1D(**VAE)
                                  .state_dict())
    _states_equal(state_t, part1.final_state)


def test_max_to_keep_deletes_oldest(tmp_path):
    model = ConvVAE1D(**VAE)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    ckpt = CK.TrainCheckpointer(str(tmp_path / "run"), max_to_keep=2)
    assert ckpt.latest_epoch() is None and ckpt.restore() is None
    for epoch in (1, 2, 3, 5, 4):
        ckpt.save(epoch, model.state_dict(), opt.state_dict())
    assert ckpt.epochs() == [4, 5] and ckpt.latest_epoch() == 5
    assert sorted(os.listdir(tmp_path / "run")) == ["epoch_4", "epoch_5"]
    assert sorted(os.listdir(tmp_path / "run" / "epoch_5")) == [
        "meta.msgpack", "model.msgpack", "opt.msgpack"]
    assert ckpt.restore(epoch=4)[2] == 4
    ckpt.save(5, model.state_dict(), opt.state_dict())     # overwrite
    assert ckpt.epochs() == [4, 5]
    with pytest.raises(ValueError, match="max_to_keep"):
        CK.TrainCheckpointer(str(tmp_path / "x"), max_to_keep=0)


def test_save_pytree_round_trips_a_state_dict(tmp_path):
    model = ConvVAE1D(**VAE)
    state = model.state_dict()
    path = CK.save_pytree(str(tmp_path / "state.msgpack"), state)
    assert os.path.isabs(path)
    _states_equal(CK.load_pytree(path, ConvVAE1D(**VAE).state_dict()), state)
    plain = CK.load_pytree(path)
    assert isinstance(plain, dict)
    _states_equal(plain, state)
    # the file is the msgpack of the model files: numpy arrays by key
    raw = msgpack_io.load(path)
    np.testing.assert_array_equal(raw["fc_mu.weight"],
                                  state["fc_mu.weight"].numpy())
    tree = {"a": [torch.arange(3), (1.5, None, True)], "b": {"c": "text"},
            "d": np.float32(2.5)}
    back = CK.load_pytree(CK.save_pytree(str(tmp_path / "t"), tree), tree)
    assert torch.equal(back["a"][0], tree["a"][0])
    assert back["a"][1] == (1.5, None, True) and back["b"] == {"c": "text"}
    with pytest.raises(ValueError, match="bfloat16"):
        CK.save_pytree(str(tmp_path / "bf"), {"w": torch.zeros(2).bfloat16()})
    with pytest.raises(ValueError, match="keys"):
        CK.load_pytree(path, {"other": torch.zeros(1)})


def test_timeit_and_throughput():
    x = torch.ones(256, 256)
    stats = profiling.timeit(lambda a: (a * a).sum(), x, warmup=1, repeats=3)
    assert stats["best"] > 0 and stats["best"] <= stats["mean"]
    assert len(stats["times"]) == 3
    assert profiling.throughput(lambda a: a @ a, 256, x, warmup=1,
                                repeats=2) > 0
    calls = []
    profiling.timeit(lambda: calls.append(1) or {"t": [x]}, warmup=0,
                     repeats=2)
    assert len(calls) == 3                       # one warm-up at least
    assert profiling.synchronize({"a": (x, [x])})["a"][0] is x


def test_epoch_logger(capsys):
    log = profiling.EpochLogger(print_every=2)
    for e in range(4):
        log.log(e, 1.0 / (e + 1), 2.0 / (e + 1), lr=1e-3)
    out = capsys.readouterr().out
    assert "Epoch 1" in out and "Epoch 2" in out and "Epoch 4" in out
    assert "Epoch 3" not in out
    hist = log.history()
    assert len(hist["train_losses"]) == 4 and log.rows[0]["lr"] == 1e-3
    np.testing.assert_allclose(hist["val_losses"][0], 2.0)


def test_trace_writes_annotated_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        with profiling.annotate("ocm_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "ocm_span" in names
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "ocm_span" for e in events)


@pytest.mark.filterwarnings("ignore:Error detected")
def test_debug_nans_traps_a_nan_gradient():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with profiling.debug_nans():
            torch.sqrt(x - 1.0).sum().backward()
    y = torch.zeros(3, requires_grad=True)
    torch.sqrt(y - 1.0).sum().backward()          # outside: no trap
    assert torch.isnan(y.grad).all()
    assert not torch.is_anomaly_enabled()


@pytest.fixture
def agg():
    import matplotlib

    matplotlib.use("Agg", force=True)
    return matplotlib


def test_plots_write_files_from_arrays_and_tensors(tmp_path, agg):
    from ocm_tpu_torch.utils.synthetic import nut_cube
    from ocm_tpu_torch.utils.native import label

    rng = np.random.default_rng(0)
    t2, q = torch.as_tensor(rng.uniform(0, 2, 50)), rng.uniform(0, 2, 50)
    paths = []
    for i, (kind, log) in enumerate((("alt", False), ("sim", True),
                                     ("ci", False))):
        paths.append(report.plot_t2q(
            t2, q, labels=torch.as_tensor(rng.integers(0, 2, 50)),
            d_limit=torch.tensor(1.5), decision_type=kind, log_scale=log,
            save_path=str(tmp_path / f"t2q{i}.png")))
    paths.append(report.plot_t2q_classes(
        {0: None, 1: None},
        lambda cls, x: (rng.uniform(0, 2, len(x)), torch.as_tensor(
            rng.uniform(0, 2, len(x))), torch.tensor(np.sqrt(2.0))),
        rng.normal(0, 1, (40, 8)), rng.integers(0, 2, 40),
        save_path=str(tmp_path / "panel.png")))
    res = {"results": [{"params": {"type": "alt"}, "LV": lv, "eff": 90 + lv}
                       for lv in range(2, 6)],
           "best_params": {"type": "alt"}, "best_LV": 5, "best_score": 95.0}
    paths.append(report.plot_cv(res, save_path=str(tmp_path / "cv.png")))
    paths.append(report.plot_confusion(
        torch.tensor([[10, 2, 1], [3, 20, 15]]), [0, 1, 2],
        save_path=str(tmp_path / "conf.png")))
    paths.append(report.plot_losses(
        torch.tensor([3.0, 2.0, 1.0]), [3.1, 2.2, 1.5], best_epoch=2,
        save_path=str(tmp_path / "loss.png")))
    cube = nut_cube(seed=2, height=40, width=40, length=12)
    labels, n = label(cube.mean(axis=2) >= 0.5)
    paths.append(report.plot_segmentation(
        cube, torch.as_tensor(labels), n, save_path=str(tmp_path / "seg.png")))
    paths.append(report.plot_extraction(
        cube, labels, 1, save_path=str(tmp_path / "obj.png")))
    for p in paths:
        assert os.path.getsize(p) > 0, p
    assert len(paths) == 9
    fig = report.plot_losses([1.0, 0.5])        # no path: the figure back
    assert fig.axes and agg.get_backend().lower() == "agg"
    with pytest.raises(ValueError, match="no CV records"):
        report.plot_cv(res, params={"nope": 1})


def test_plot_t2q_interactive_needs_plotly():
    try:
        import plotly.graph_objects  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="plot_t2q"):
            report.plot_t2q_interactive([0.5], [0.5])
    else:
        fig = report.plot_t2q_interactive(torch.tensor([0.5]), [0.5],
                                          labels=[0])
        assert len(fig.data) == 2
