"""The port's TPE sampler, median pruner and searches
(``ocm_tpu_torch.utils.tpe``, the sampling of ``ocm_tpu_torch.utils.sweep``)
against ``ocm_tpu``'s, on the CPU.

The host half is the JAX package's numpy, copied: for one seed and one
told history the suggestions, prune decisions, samples and search
histories must be equal bit for bit (``==`` on the floats).  The VAE
searches (``tpe_vae_search``, ``bohb_vae_search``) are held to ``ocm_tpu``'s
schedules with the trainer replaced in both packages by one deterministic
fake, and run end to end on the port's real trainer at a tiny size
(mirroring ``tests/test_tpe.py``).
"""

import numpy as np
import pytest
import torch

from ocm_tpu.models import trainer as JT
from ocm_tpu.utils import sweep as JS
from ocm_tpu.utils import tpe as JTPE
from ocm_tpu_torch.models import trainer as TT
from ocm_tpu_torch.utils import sweep as TS
from ocm_tpu_torch.utils import tpe as TTPE

SEEDS = [0, 1, 2]
SPACE = {
    "lr": ("loguniform", 1e-5, 1e-1),
    "dropout": ("uniform", 0.0, 0.5),
    "width": ("int", 4, 64),
    "act": ("categorical", ["relu", "elu", "gelu", "tanh"]),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _objective(cfg):
    """A smooth bowl (optimum lr 1e-3, dropout 0.2, width 32, elu) that
    diverges (inf, then NaN) at the largest rates."""
    if cfg["lr"] > 3e-2:
        return np.inf if cfg["width"] % 2 else np.nan
    v = (np.log10(cfg["lr"]) + 3.0) ** 2
    v += 10.0 * (cfg["dropout"] - 0.2) ** 2
    v += ((cfg["width"] - 32) / 16.0) ** 2
    return v + (0.0 if cfg["act"] == "elu" else 1.0)


@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_sampler_suggestions_equal_jax(seed, maximize):
    """40 suggest/tell rounds (startup, then Parzen ranking; diverged
    values among the told ones): the same configs, bit for bit."""
    ref = JTPE.TPESampler(SPACE, seed=seed, n_startup_trials=6,
                          maximize=maximize)
    got = TTPE.TPESampler(SPACE, seed=seed, n_startup_trials=6,
                          maximize=maximize)
    for _ in range(40):
        a, b = ref.suggest(), got.suggest()
        assert a == b
        ref.tell(a, _objective(a))
        got.tell(b, _objective(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_median_pruner_equals_jax(seed):
    """Random report streams (NaN included, several trials, steps out of
    order): every prune decision equal."""
    rng = np.random.default_rng(seed)
    warm = int(rng.integers(0, 4))
    ref = JTPE.MedianPruner(n_warmup_steps=warm, maximize=bool(seed % 2))
    got = TTPE.MedianPruner(n_warmup_steps=warm, maximize=bool(seed % 2))
    for _ in range(200):
        tid, step = int(rng.integers(0, 6)), int(rng.integers(0, 8))
        value = float(rng.normal()) if rng.random() > 0.05 else np.nan
        ref.report(tid, step, value)
        got.report(tid, step, value)
        assert ref.should_prune(tid) == got.should_prune(tid)
    cb_r, cb_g = ref.trial_callback(9), got.trial_callback(9)
    for e in range(6):
        assert cb_r(e, 0.0, 1.0 + e) == cb_g(e, 0.0, 1.0 + e)


@pytest.mark.parametrize("seed", SEEDS)
def test_tpe_search_equals_jax(seed):
    for maximize in (False, True):
        obj = _objective if not maximize else (lambda c: -_objective(c))
        ref = JTPE.tpe_search(obj, SPACE, 25, seed=seed, maximize=maximize,
                              n_startup_trials=5)
        got = TTPE.tpe_search(obj, SPACE, 25, seed=seed, maximize=maximize,
                              n_startup_trials=5)
        np.testing.assert_equal(got, ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_config_equals_jax(seed):
    for space in (SPACE, TS.SEARCH_SPACE_DEFAULT):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(30):
            assert TS.sample_config(space, r2) == JS.sample_config(space, r1)
    assert TS.SEARCH_SPACE_DEFAULT == JS.SEARCH_SPACE_DEFAULT
    with pytest.raises(ValueError, match="kind"):
        TS.sample_config({"z": ("nope", 1)}, np.random.default_rng(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_search_equals_jax(seed):
    for maximize in (False, True):
        ref = JS.random_search(_objective, SPACE, 20, seed=seed,
                               maximize=maximize)
        got = TS.random_search(_objective, SPACE, 20, seed=seed,
                               maximize=maximize)
        np.testing.assert_equal(got, ref)


def test_grid_product_equals_jax():
    base = {"epochs": 5, "lr": 1e-3}
    grid = {"lr": [1e-3, 1e-2], "beta": [0.1, 1.0], "latent_dim": [4, 8, 16]}
    assert TS.grid_product(base, grid) == JS.grid_product(base, grid)
    assert len(TS.grid_product(base, grid)) == 12


def test_tpe_validates_space_and_gamma():
    with pytest.raises(ValueError, match="kind"):
        TTPE.TPESampler({"x": ("normal", 0, 1)})
    with pytest.raises(ValueError, match="gamma"):
        TTPE.TPESampler(SPACE, gamma=1.5)


# ---------------------------------------------------------------------------
# The VAE searches under one deterministic fake trainer, in both packages
# ---------------------------------------------------------------------------


def _curve(lr, beta, epoch):
    """The fake validation loss: a bowl in lr, falling with the epoch, NaN
    from the largest rates on."""
    if lr > 5e-3:
        return np.nan
    return (np.log10(lr) + 3.0) ** 2 + 0.1 * beta + 1.0 / (1.0 + epoch)


def _fake_blocked(result):
    """A ``train_vae_blocked`` stand-in: the curve of the trial's lr and
    beta, reported epoch by epoch, stopping at the edge of the block a
    prune fell in, as the real trainer does."""
    def fake(model, x_cal, x_val, cfg, seed, block_epochs=10, report=None,
             spec_stats=None, **_):
        vls, done, stop = [], 0, False
        while done < cfg.epochs and not stop:
            k = min(block_epochs, cfg.epochs - done)
            for e in range(done, done + k):
                vls.append(_curve(cfg.lr, cfg.beta, e))
                if report is not None and report(e, vls[-1], vls[-1]):
                    stop = True
                    break
            done += k
        vls = np.asarray(vls)
        return result(("bundle", len(vls)), vls)
    return fake


def _jax_result(bundle, vls):
    return JT.TrainResult(bundle, vls, vls, 0, None, None, None)


def _port_result(bundle, vls):
    return TT.TrainResult(bundle, vls, vls, 0, None, None)


X_FAKE = np.zeros((8, 32), np.float32)
SPACE_VAE = {"lr": ("loguniform", 1e-4, 1e-2),
             "beta": ("loguniform", 1e-3, 4.0)}


@pytest.mark.parametrize("block_epochs", [1, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_tpe_vae_search_schedule_equals_jax(monkeypatch, seed,
                                            block_epochs):
    """The same trials, values, prunes and epoch accounting (to the block
    edge) as ``ocm_tpu`` over the same fake trainer."""
    monkeypatch.setattr(JT, "train_vae_blocked", _fake_blocked(_jax_result))
    monkeypatch.setattr(TT, "train_vae_blocked",
                        _fake_blocked(_port_result))
    kw = dict(space=SPACE_VAE, n_trials=8, max_epochs=7, seed=seed,
              block_epochs=block_epochs, n_warmup_steps=2, verbose=False)
    ref = JTPE.tpe_vae_search(X_FAKE, X_FAKE, **kw)
    got = TTPE.tpe_vae_search(X_FAKE, X_FAKE, **kw, device="cpu")
    for key in ("best_config", "best_value", "history", "total_epochs",
                "n_pruned"):
        np.testing.assert_equal(got[key], ref[key], err_msg=key)
    assert got["best_bundle"] == ref["best_bundle"]
    assert got["n_pruned"] > 0


def _fake_vmapped(result):
    """A ``train_vae_vmapped`` stand-in: each config's curve over the
    rung's epochs, a bundle and a state that name the config."""
    def fake(model, x_cal, x_val, lrs, weight_decays, betas, epochs,
             batch_size, loss_type, init_state=None, epoch_offset=0, **_):
        vls = np.array([[_curve(lr, b, epoch_offset + e)
                         for e in range(epochs)]
                        for lr, b in zip(lrs, betas)])
        if init_state is not None:
            # survivors come back re-stacked, in the group's order
            np.testing.assert_array_equal(np.asarray(init_state[0]["lr"]),
                                          np.asarray(lrs))
        return result(np.asarray(lrs), vls)
    return fake


def _jax_vmapped_result(lrs, vls):
    return JT.TrainResult({"lr": lrs}, vls, vls, np.zeros(len(lrs)),
                          {"lr": lrs}, {"lr": lrs}, {"lr": lrs})


def _port_vmapped_result(lrs, vls):
    t = torch.as_tensor(lrs)
    return TT.TrainResult({"lr": t}, vls, vls, np.zeros(len(lrs)),
                          {"lr": t}, {"step": 0, "lr": t})


@pytest.mark.parametrize("seed", SEEDS)
def test_asha_and_bohb_schedules_equal_jax(monkeypatch, seed):
    """ASHA (sampled and explicit cohorts, two architecture groups) and
    BOHB: the same history, rungs, total epochs, kills, trials and best
    config as ``ocm_tpu`` over the same fake rung trainer."""
    monkeypatch.setattr(JS, "train_vae_vmapped",
                        _fake_vmapped(_jax_vmapped_result))
    monkeypatch.setattr(TS, "train_vae_vmapped",
                        _fake_vmapped(_port_vmapped_result))
    space = {**SPACE_VAE, "latent_dim": ("categorical", [4, 8])}
    runs = [
        (JS.asha_vae_search, TS.asha_vae_search,
         dict(space=space, n_trials=9, max_epochs=9, reduction=3,
              seed=seed)),
        (JS.asha_vae_search, TS.asha_vae_search,
         dict(space=None, max_epochs=8, reduction=2, min_epochs=2,
              seed=seed, configs=[{"lr": 1e-3}, {"lr": 2e-2},
                                  {"lr": 3e-4}, {"lr": 2e-3}])),
        (JTPE.bohb_vae_search, TTPE.bohb_vae_search,
         dict(space=space, n_brackets=3, trials_per_bracket=4,
              max_epochs=6, reduction=2, seed=seed))]
    for ref_fn, got_fn, kw in runs:
        ref = ref_fn(X_FAKE, X_FAKE, verbose=False, **kw)
        got = got_fn(X_FAKE, X_FAKE, verbose=False, device="cpu", **kw)
        keys = ["best_config", "best_value", "history", "total_epochs"]
        if "rungs" in ref:
            keys += ["rungs", "trials"]
        for key in keys:
            np.testing.assert_equal(got[key], ref[key], err_msg=key)
        assert float(got["best_bundle"]["lr"]) == float(
            ref["best_bundle"]["lr"])


# ---------------------------------------------------------------------------
# The searches on the port's real trainer (tests/test_tpe.py's cases)
# ---------------------------------------------------------------------------

BASE = {"latent_dim": 4, "conv_blocks": 1, "n_filters": 4, "kernel_size": 5,
        "hidden_fc": 16, "batch_size": 16, "loss_type": "euclidean"}


@pytest.fixture(scope="module")
def spectra():
    rng = np.random.default_rng(0)
    base = np.sin(np.linspace(0, 6, 32))
    x = base + 0.1 * rng.standard_normal((64, 32))
    return x[:48].astype(np.float32), x[48:].astype(np.float32)


def test_tpe_vae_search_end_to_end(spectra):
    x_cal, x_val = spectra
    out = TTPE.tpe_vae_search(x_cal, x_val, space=SPACE_VAE, n_trials=4,
                              max_epochs=4, seed=0, base_config=BASE,
                              block_epochs=2, n_warmup_steps=1,
                              verbose=False, device="cpu")
    assert out["best_bundle"] is not None
    assert np.isfinite(out["best_value"])
    assert len(out["history"]) == 4
    assert out["total_epochs"] <= 4 * 4
    for h in out["history"]:
        assert h["epochs"] <= 4
        assert set(BASE) <= set(h["config"])
        if h["pruned"]:
            assert h["epochs"] < 4


def test_bohb_vae_search_end_to_end(spectra):
    x_cal, x_val = spectra
    out = TTPE.bohb_vae_search(x_cal, x_val, space=SPACE_VAE, n_brackets=2,
                               trials_per_bracket=4, max_epochs=4,
                               reduction=2, seed=0, base_config=BASE,
                               verbose=False, device="cpu")
    assert out["best_bundle"] is not None
    assert np.isfinite(out["best_value"])
    assert len(out["history"]) == 2
    assert out["total_epochs"] < 2 * 4 * 4
    for h in out["history"]:
        assert len(h["trials"]) == 4
        for tr in h["trials"]:
            assert set(BASE) <= set(tr["config"])
            assert 1 <= tr["epochs"] <= 4
    assert out["best_value"] == min(h["best_value"] for h in out["history"])
    with pytest.raises(ValueError, match="n_brackets"):
        TTPE.bohb_vae_search(x_cal, x_val, space=SPACE_VAE, n_brackets=0)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        TTPE.bohb_vae_search(x_cal, x_val, space=SPACE_VAE, mesh=object())


def test_bohb_samples_second_bracket_adaptively(monkeypatch):
    """The sampler is told every bracket-0 trial before bracket 1 draws."""
    monkeypatch.setattr(TS, "train_vae_vmapped",
                        _fake_vmapped(_port_vmapped_result))
    seen = []
    orig = TTPE.TPESampler.suggest

    def spy(self):
        seen.append(len(self._values))
        return orig(self)

    monkeypatch.setattr(TTPE.TPESampler, "suggest", spy)
    TTPE.bohb_vae_search(X_FAKE, X_FAKE, space={"lr": SPACE_VAE["lr"]},
                         n_brackets=2, trials_per_bracket=3, max_epochs=2,
                         reduction=2, seed=0, verbose=False, device="cpu")
    assert seen[:3] == [0, 0, 0]
    assert all(n == 3 for n in seen[3:6])


def test_asha_explicit_configs_cohort(spectra):
    x_cal, x_val = spectra
    cohort = [{"lr": 1e-3}, {"lr": 3e-3}, {"lr": 1e-2}]
    out = TS.asha_vae_search(x_cal, x_val, None, n_trials=99,  # ignored
                             max_epochs=4, reduction=2, seed=0,
                             base_config=BASE, configs=cohort,
                             verbose=False, device="cpu")
    assert len(out["trials"]) == 3
    for tr, cfg in zip(out["trials"], cohort):
        assert tr["config"]["lr"] == cfg["lr"]
    assert out["best_config"]["lr"] in [c["lr"] for c in cohort]
    with pytest.raises(ValueError, match="non-empty"):
        TS.asha_vae_search(x_cal, x_val, None, base_config=BASE, configs=[])


@pytest.mark.parametrize("script,want", [([0.45, 0.40, np.nan], 0.40),
                                         ([np.nan, 0.7, 0.9], 0.7)],
                         ids=["nan-tail", "nan-head"])
def test_tpe_scores_partially_diverged_trial_by_best_finite(monkeypatch,
                                                            script, want):
    def fake(model, x_cal, x_val, cfg, seed, **_):
        vls = np.asarray(script)
        return TT.TrainResult("bundle", vls, vls,
                              int(np.nanargmin(vls)), None, None)

    monkeypatch.setattr(TT, "train_vae_blocked", fake)
    out = TTPE.tpe_vae_search(X_FAKE, X_FAKE[:4],
                              space={"lr": SPACE_VAE["lr"]}, n_trials=2,
                              max_epochs=3, seed=0, verbose=False,
                              device="cpu")
    assert out["best_value"] == pytest.approx(want)
    assert out["best_bundle"] == "bundle"
    for h in out["history"]:
        assert h["value"] == pytest.approx(want)


def test_tpe_epoch_accounting_counts_to_block_boundary(monkeypatch):
    def fake(model, x_cal, x_val, cfg, seed, **_):
        vls = np.asarray([0.5])
        return TT.TrainResult("bundle", vls, vls, 0, None, None)

    monkeypatch.setattr(TT, "train_vae_blocked", fake)
    out = TTPE.tpe_vae_search(X_FAKE, X_FAKE[:4],
                              space={"lr": SPACE_VAE["lr"]}, n_trials=2,
                              max_epochs=8, block_epochs=4, seed=0,
                              verbose=False, device="cpu")
    for h in out["history"]:
        assert (h["epochs"], h["epochs_device"], h["pruned"]) == (1, 4, True)
    assert out["total_epochs"] == 8
