"""The port's stacked VAE training and sweeps (``ocm_tpu_torch.models.
stacked``, ``ocm_tpu_torch.utils.sweep``) against ``ocm_tpu`` and against
the port's own sequential trainer, on the CPU.

- One stacked step of C = 3 configs (different lr, weight decay and beta)
  against ``jax.vmap`` over the JAX model (BatchNorm through the Pallas
  kernels in interpret mode) and ``traced_adam``, 3 steps in float64 with
  the batches and noise passed in, through the weight and Adam carriers.
- ``train_vae_vmapped``'s config c against ``train_vae(seeded_vae(model,
  s_c), ..., seed=s_c)`` in float64 (JAX's random streams cannot be
  replayed in torch, so the stacked trainer is held to the port's own
  sequential one), resume, a diverging config, the class trainer and its
  padding, ASHA on the real trainer, the artifact runner and the Optuna
  adapters (``tests/test_sweep.py``'s cases).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocm_tpu.models import vae as JV
from ocm_tpu.utils import sweep as JS
from ocm_tpu_torch.models import bundle as TBd
from ocm_tpu_torch.models import stacked as TSt
from ocm_tpu_torch.models import trainer as TT
from ocm_tpu_torch.models import vae as TV
from ocm_tpu_torch.models.vae_decision import fit_thresholds
from ocm_tpu_torch.serving import VAEScorer
from ocm_tpu_torch.utils import sweep as TS
from torch_port_data import VAE_SMALL, perturb_bn, vae_spectra

C, B, STEPS = 3, 8, 3
LRS, WDS, BETAS = [1e-3, 3e-3, 5e-4], [0.0, 1e-2, 1e-3], [1.0, 0.3, 2.0]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _stack(trees):
    return jax.tree.map(lambda *a: np.stack(a), *trees)


# ---------------------------------------------------------------------------
# one stacked step against jax.vmap
# ---------------------------------------------------------------------------


def _jax_fwd(mod, x, eps):
    mu, lv = mod.encode(x, train=True)
    return mod.decode(mu + eps * jnp.exp(0.5 * lv), train=True), mu, lv


@functools.lru_cache(maxsize=None)
def _jax_trajectory(loss_type):
    """C configs' initial trees (each its own init key and BatchNorm
    perturbation), the batches and noise, and JAX's vmapped 3-step run:
    per step the losses and the trees the step started from."""
    jmodel = JV.ConvVAE1D(**VAE_SMALL, dtype=jnp.float64, bn_impl="fused")
    inits = [perturb_bn(*(_f64(t) for t in JV.init_vae(
        jmodel, jax.random.key(c))), seed=5 + c) for c in range(C)]
    params = _stack([p for p, _ in inits])
    stats = _stack([s for _, s in inits])
    x = vae_spectra(STEPS * C * B, VAE_SMALL["input_length"], seed=6)
    x = ((x - x.mean(0)) / x.std(0)).reshape(STEPS, C, B, -1)
    eps = np.random.default_rng(7).normal(
        size=(STEPS, C, B, VAE_SMALL["latent_dim"]))

    def loss_fn(p, s, xb, e, beta):
        (x_rec, mu, lv), mut = jmodel.apply(
            {"params": p, "batch_stats": s}, xb, e, method=_jax_fwd,
            mutable=["batch_stats"])
        total, _, _ = JV.beta_vae_loss(xb, x_rec, mu, lv, beta=beta,
                                       loss_type=loss_type)
        return total, mut["batch_stats"]

    def one(p, s, o, xb, e, beta, lr, wd):
        (loss, s), g = jax.value_and_grad(loss_fn, has_aux=True)(
            p, s, xb, e, beta)
        updates, o = JS.traced_adam(lr, wd).update(g, o, p)
        return optax.apply_updates(p, updates), s, o, loss

    step = jax.jit(jax.vmap(one))
    lrs, wds, betas = (np.asarray(v) for v in (LRS, WDS, BETAS))
    opt = jax.vmap(lambda p, lr, wd: JS.traced_adam(lr, wd).init(p))(
        params, lrs, wds)
    p, s, o, losses, trees = params, stats, opt, [], []
    for i in range(STEPS):
        trees.append((_f64(p), _f64(s)))
        p, s, o, loss = step(p, s, o, jnp.asarray(x[i]), jnp.asarray(eps[i]),
                             betas, lrs, wds)
        losses.append(np.asarray(loss))
    trees.append((_f64(p), _f64(s)))
    adam = o[1]
    return (params, stats, x, eps, np.stack(losses), trees,
            (np.asarray(adam.count), _f64(adam.mu), _f64(adam.nu)))


# the conv biases ahead of a BatchNorm: their exact gradient is 0 (the
# BatchNorm removes any constant), so both packages hold rounding there,
# which Adam's normalisation (and the L2 term) turn into steps of up to
# ~lr; they reach nothing but the running mean of the BatchNorm after them
NOISE_BIASES = {"encoder_conv.0.bias": "encoder_conv.1.running_mean",
                "encoder_conv.3.bias": "encoder_conv.4.running_mean",
                "decoder_conv.0.bias": "decoder_conv.1.running_mean",
                "decoder_conv.3.bias": "decoder_conv.4.running_mean"}


def _rel(got, ref):
    """max |got - ref| over max |ref| (the error itself where ref is 0)."""
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() or 1.0)


@pytest.mark.parametrize("loss_type", ["bce", "cosine"])
def test_stacked_steps_match_jax_vmap(loss_type):
    """Losses, parameters, BatchNorm running statistics and Adam moments of
    3 stacked steps within 1e-10 (max error over the tensor's largest
    entry) of JAX's.  The conv biases ahead of a BatchNorm hold rounding
    noise in both packages (``NOISE_BIASES``): each of them is held to
    Adam's step bound, 2 * 3 steps * 3.2 lr (|m_hat| / sqrt(v_hat) <=
    (1 - b1) / sqrt(1 - b2)), and the running mean after it to 1e-10
    once the bias difference it averaged in (0.1 * 0.9^k a step, known
    from both runs) is taken out; their Adam moments are moments of that
    noise and are not compared."""
    (params, stats, x, eps, losses_r, trees,
     (count, mu, nu)) = _jax_trajectory(loss_type)
    tmodel = TV.ConvVAE1D(**VAE_SMALL)
    smodel = TSt.stacked_vae(tmodel, TSt.stacked_state_dict_from_numpy(
        params, stats, tmodel))
    assert next(smodel.parameters()).dtype == torch.float64
    opt = TSt.StackedAdam(smodel, LRS, WDS)
    step = TSt.make_stacked_train_step(
        smodel, opt, TT.TrainConfig(loss_type=loss_type), BETAS)
    biases, losses = [], []
    for i in range(STEPS):
        biases.append({k: smodel.state_dict()[k].clone()
                       for k in NOISE_BIASES})
        losses.append(step(torch.tensor(x[i]), torch.tensor(eps[i])).numpy())
    assert _rel(losses, losses_r) <= 1e-10

    refs = [TSt.stacked_state_dict_from_numpy(p, s, tmodel)
            for p, s in trees]
    state = smodel.state_dict()
    for name, v in state.items():
        if "num_batches" in name:
            assert (v == STEPS).all()
            continue
        got, ref = v.numpy(), refs[-1][name].numpy()
        if name in NOISE_BIASES:
            bound = 2 * STEPS * 3.2 * np.asarray(LRS)[:, None]
            assert (np.abs(got - ref) <= bound).all(), name
            continue
        if name in NOISE_BIASES.values():
            bias = next(b for b, m in NOISE_BIASES.items() if m == name)
            got = got - sum(0.1 * 0.9 ** (STEPS - 1 - i) * (
                biases[i][bias].numpy() - refs[i][bias].numpy())
                for i in range(STEPS))
        assert _rel(got, ref) <= 1e-10, name

    mine = opt.state_dict()
    carried = TSt.stacked_adam_state_from_numpy(count, mu, nu, tmodel)
    assert mine["step"] == carried["step"] == STEPS
    for key in ("exp_avg", "exp_avg_sq"):
        assert mine[key].keys() == carried[key].keys()
        for name in mine[key]:
            if name not in NOISE_BIASES:
                assert _rel(mine[key][name], carried[key][name]) <= 1e-10, (
                    key, name)


def test_carriers_round_trip():
    """The weight and Adam carriers are inverses of their inverses."""
    params, stats, *_, (count, mu, nu) = _jax_trajectory("bce")
    tmodel = TV.ConvVAE1D(**VAE_SMALL, dropout=0.1)
    state = TSt.stacked_state_dict_from_numpy(params, stats, tmodel)
    p2, s2 = TSt.stacked_state_dict_to_numpy(state, tmodel)
    np.testing.assert_equal(p2, params)
    np.testing.assert_equal(s2, stats)
    adam = TSt.stacked_adam_state_from_numpy(count, mu, nu, tmodel)
    c2, mu2, nu2 = TSt.stacked_adam_state_to_numpy(adam, tmodel)
    np.testing.assert_equal(c2, count)
    np.testing.assert_equal(mu2, mu)
    np.testing.assert_equal(nu2, nu)
    with pytest.raises(ValueError, match="counts differ"):
        TSt.stacked_adam_state_from_numpy(np.arange(C), mu, nu, tmodel)


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_stacked_forward_equals_single_models(dropout):
    """Train and eval forwards of the stacked module equal C single models
    bit for bit (dropout masks from each config's generator), and the
    stacked state dict is ``stack_vaes`` of theirs."""
    tmodel = TV.ConvVAE1D(**VAE_SMALL, dropout=dropout, activation="gelu")
    singles = [TSt.seeded_vae(tmodel, s).double() for s in range(C)]
    smodel = TSt.stacked_vae(tmodel, singles)
    for k, v in smodel.state_dict().items():
        for c in range(C):
            assert torch.equal(v[c], singles[c].state_dict()[k])
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(C, B, VAE_SMALL["input_length"])))
    eps = torch.tensor(rng.normal(size=(C, B, VAE_SMALL["latent_dim"])))
    for train in (True, False):
        smodel.train(train)
        smodel.dropout_generators = [torch.Generator().manual_seed(c)
                                     for c in range(C)]
        mu, lv = smodel.encode(x)
        rec = smodel.decode(smodel.reparameterize(mu, lv, eps)[0])
        for c, m in enumerate(singles):
            m.train(train)
            m.dropout_generator = torch.Generator().manual_seed(c)
            rec_c, mu_c, lv_c = m(x[c], eps[c])
            assert torch.equal(rec[c], rec_c)
            assert torch.equal(mu[c], mu_c) and torch.equal(lv[c], lv_c)
    with pytest.raises(ValueError, match="generators"):
        smodel.dropout_generators = [None]


# ---------------------------------------------------------------------------
# the stacked trainer against the port's sequential trainer
# ---------------------------------------------------------------------------


def _data(n=48, m=16, seed=8):
    x = vae_spectra(n + m, VAE_SMALL["input_length"], seed=seed)
    return x[:n], x[n:]


def _sequential(model, x_cal, x_val, c, seeds, epochs, **kw):
    cfg = TT.TrainConfig(epochs=epochs, batch_size=kw.get("batch_size", 16),
                         lr=LRS[c], weight_decay=WDS[c], beta=BETAS[c],
                         loss_type=kw.get("loss_type", "bce"),
                         val_every=kw.get("val_every", 1),
                         loss_space=kw.get("loss_space", "std"))
    return TT.train_vae(TSt.seeded_vae(model, seeds[c]), x_cal, x_val, cfg,
                        seed=seeds[c], device="cpu")


CASES = [dict(loss_type="bce", dropout=0.1),
         dict(loss_type="cosine", loss_space="raw", val_every=2),
         dict(loss_type="euclidean", activation="gelu", batch_size=20)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_vmapped_config_equals_sequential_trainer(case):
    """Config c of ``train_vae_vmapped`` runs ``train_vae(seeded_vae(model,
    s_c), seed=s_c)``: train and val losses within 1e-8 (relative to the
    run's largest), the same best epoch, best and final weights within
    1e-8, in float64.  Default seeds are ``config_seed(seed, c)``."""
    case = dict(case)
    arch = {k: case.pop(k) for k in ("dropout", "activation") if k in case}
    model = TV.ConvVAE1D(**VAE_SMALL, **arch)
    x_cal, x_val = _data()
    res = TS.train_vae_vmapped(model, x_cal, x_val, LRS, WDS, BETAS,
                               epochs=4, batch_size=case.get("batch_size", 16),
                               loss_type=case.get("loss_type"), seed=11,
                               loss_space=case.get("loss_space", "std"),
                               val_every=case.get("val_every", 1),
                               device="cpu")
    seeds = [TSt.config_seed(11, c) for c in range(C)]
    assert res.train_losses.shape == res.val_losses.shape == (C, 4)
    assert res.bundle.spec_mean.shape == (C, VAE_SMALL["input_length"])
    for c in range(C):
        seq = _sequential(model, x_cal, x_val, c, seeds, 4, **case)
        assert _rel(res.train_losses[c], seq.train_losses) <= 1e-8
        finite = np.isfinite(seq.val_losses)
        np.testing.assert_array_equal(np.isfinite(res.val_losses[c]),
                                      finite)
        assert _rel(res.val_losses[c][finite],
                    seq.val_losses[finite]) <= 1e-8
        assert res.best_epoch[c] == seq.best_epoch
        for k, v in seq.bundle.state_dict.items():
            if v.is_floating_point():
                assert _rel(res.bundle.state_dict[k][c], v) <= 1e-8, k
                assert _rel(res.final_state[k][c], seq.final_state[k]) \
                    <= 1e-8, k


def test_vmapped_resume_equals_one_call():
    """E1 + E2 epochs resumed from ``(final_state, final_opt_state)`` and
    ``epoch_offset`` equal E1 + E2 in one call, bit for bit."""
    model = TV.ConvVAE1D(**VAE_SMALL, dropout=0.1)
    x_cal, x_val = _data()
    kw = dict(batch_size=16, loss_type="bce", seed=4, device="cpu")
    whole = TS.train_vae_vmapped(model, x_cal, x_val, LRS, WDS, BETAS,
                                 epochs=5, **kw)
    a = TS.train_vae_vmapped(model, x_cal, x_val, LRS, WDS, BETAS,
                             epochs=2, **kw)
    b = TS.train_vae_vmapped(model, x_cal, x_val, LRS, WDS, BETAS, epochs=3,
                             init_state=(a.final_state, a.final_opt_state),
                             epoch_offset=2, **kw)
    np.testing.assert_array_equal(
        np.concatenate([a.val_losses, b.val_losses], 1), whole.val_losses)
    np.testing.assert_array_equal(
        np.concatenate([a.train_losses, b.train_losses], 1),
        whole.train_losses)
    for k, v in whole.final_state.items():
        assert torch.equal(b.final_state[k], v), k
    assert b.final_opt_state["step"] == whole.final_opt_state["step"] == 15


def test_diverging_config_leaves_the_others():
    """A config at lr 10 diverges (NaN) and never wins its best epoch; the
    others stay equal to their sequential runs, as if alone."""
    model = TV.ConvVAE1D(**VAE_SMALL)
    x_cal, x_val = _data()
    lrs = [1e-3, 10.0, 3e-3]
    res = TS.train_vae_vmapped(model, x_cal, x_val, lrs, WDS, BETAS,
                               epochs=4, batch_size=16, loss_type="bce",
                               seed=2, device="cpu")
    seeds = [TSt.config_seed(2, c) for c in range(C)]
    assert not np.isfinite(res.val_losses[1, -1])
    for c in (0, 2):
        cfg = TT.TrainConfig(epochs=4, batch_size=16, lr=lrs[c],
                             weight_decay=WDS[c], beta=BETAS[c],
                             loss_type="bce")
        seq = TT.train_vae(TSt.seeded_vae(model, seeds[c]), x_cal, x_val,
                           cfg, seed=seeds[c], device="cpu")
        assert _rel(res.val_losses[c], seq.val_losses) <= 1e-8
        assert res.best_epoch[c] == seq.best_epoch
        assert np.isfinite(res.train_losses[c]).all()


def test_vmapped_validates():
    model = TV.ConvVAE1D(**VAE_SMALL)
    x_cal, x_val = _data()
    with pytest.raises(ValueError, match="share their length"):
        TS.train_vae_vmapped(model, x_cal, x_val, [1e-3, 1e-3], [0.0], [1.0],
                             epochs=1, batch_size=8, loss_type="bce",
                             device="cpu")
    with pytest.raises(ValueError, match="cfg_seeds"):
        TS.train_vae_vmapped(model, x_cal, x_val, [1e-3], [0.0], [1.0],
                             epochs=1, batch_size=8, loss_type="bce",
                             cfg_seeds=[1, 2], device="cpu")


def test_entry_points_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    model = TV.ConvVAE1D(**VAE_SMALL)
    x_cal, x_val = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.train_vae_vmapped(model, x_cal, x_val, [1e-3], [0.0], [1.0],
                             epochs=1, batch_size=8, loss_type="bce")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.train_vae_classes(model, [x_cal], [x_val], TT.TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.asha_vae_search(x_cal, x_val, n_trials=2, max_epochs=1,
                           verbose=False)


# ---------------------------------------------------------------------------
# classes
# ---------------------------------------------------------------------------


def _classes(sizes=(40, 27, 33), val_sizes=(12, 9, 7), seed=12):
    rng = np.random.default_rng(seed)
    length = VAE_SMALL["input_length"]
    t = np.linspace(0, 1, length)
    make = lambda c, n: (rng.normal(1, .08, (n, 1))
                         * np.sin(2 * np.pi * (3 + c) * t) + 0.4 * c
                         + rng.normal(0, .02, (n, length)))
    return ([make(c, n) for c, n in enumerate(sizes)],
            [make(c, n) for c, n in enumerate(val_sizes)])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("with_stats", [False, True])
def test_classes_prep_equals_jax(with_stats, dtype):
    cals, vals = _classes()
    cals = [c.astype(dtype) for c in cals]
    vals = [v.astype(dtype) for v in vals]
    stats = ([(c.mean(0) + 0.1, c.std(0) * 2) for c in cals]
             if with_stats else None)
    got = TS.classes_prep(cals, vals, stats)
    ref = JS.classes_prep(cals, vals, stats)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert np.asarray(g).dtype == np.asarray(r).dtype


def test_train_vae_classes_padding_bundles_and_scorer():
    """Unequal classes: each class equals ``train_vae`` on its cyclically
    padded sets (standardized by its own statistics, its seed
    ``config_seed(seed, c)``) within 1e-8, the largest class on its own
    data; the stacked bundles are ``stack_bundles`` of the classes' and,
    thresholds fitted per class, feed the multi-class ``VAEScorer``."""
    cals, vals = _classes()
    model = TV.ConvVAE1D(**VAE_SMALL)
    cfg = TT.TrainConfig(epochs=3, batch_size=16, lr=2e-3,
                         loss_type="euclidean")
    res = TS.train_vae_classes(model, cals, vals, cfg, seed=8, device="cpu")
    assert res.val_losses.shape == (C, 3)
    bundles = []
    for c in range(C):
        mean, std = TBd.spectral_stats(cals[c])
        seq = TT.train_vae(
            TSt.seeded_vae(model, TSt.config_seed(8, c)),
            TS.cyclic_pad_to(cals[c], 40), TS.cyclic_pad_to(vals[c], 12),
            cfg, seed=TSt.config_seed(8, c), spec_stats=(mean, std),
            device="cpu")
        assert _rel(res.train_losses[c], seq.train_losses) <= 1e-8
        assert _rel(res.val_losses[c], seq.val_losses) <= 1e-8
        assert res.best_epoch[c] == seq.best_epoch
        bundles.append(seq.bundle)
    ref = TBd.stack_bundles(bundles)
    assert TBd._paths(res.bundle) == TBd._paths(ref)
    for k, v in ref.state_dict.items():
        if v.is_floating_point():
            assert _rel(res.bundle.state_dict[k], v) <= 1e-8, k
    for field in TBd.OCMBundle._fields[1:]:
        np.testing.assert_allclose(getattr(res.bundle, field),
                                   getattr(ref, field), rtol=1e-12, atol=0)

    fitted = [fit_thresholds(model, TBd.class_slice(res.bundle, c), cals[c],
                             loss_type="euclidean") for c in range(C)]
    scorer = VAEScorer(model, TBd.stack_bundles(fitted), variant="d2",
                       loss_type="euclidean", chunk_size=64)
    out = scorer.score(np.concatenate(vals))
    assert out["accept"].shape == (sum(len(v) for v in vals), C)
    own = np.repeat(np.arange(C), [len(v) for v in vals])
    for c in range(C):
        single = VAEScorer(model, fitted[c], variant="d2",
                           loss_type="euclidean", chunk_size=64)
        np.testing.assert_array_equal(
            single.score(np.concatenate(vals))["accept"],
            out["accept"][:, c])
        # each class's model accepts its own spectra more than the others'
        assert out["accept"][own == c, c].mean() > \
            out["accept"][own != c, c].mean()


def test_train_vae_classes_validates():
    model = TV.ConvVAE1D(**VAE_SMALL)
    cfg = TT.TrainConfig(epochs=1, batch_size=8)
    cals, vals = _classes()
    with pytest.raises(ValueError, match="equal-length"):
        TS.train_vae_classes(model, cals[:1], [], cfg, device="cpu")
    with pytest.raises(ValueError, match="spectral length"):
        TS.train_vae_classes(model, [cals[0], cals[1][:, :32]],
                             [vals[0], vals[1][:, :32]], cfg, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        TS.train_vae_classes(model, [cals[0], cals[1][:0]], vals[:2], cfg,
                             device="cpu")


# ---------------------------------------------------------------------------
# ASHA on the real trainer
# ---------------------------------------------------------------------------

BASE = {"latent_dim": 4, "conv_blocks": 2, "n_filters": 8, "hidden_fc": 32,
        "batch_size": 16, "loss_type": "euclidean"}


def test_asha_kills_the_diverging_config_at_the_first_rung():
    x_cal, x_val = _data()
    cohort = [{"lr": 1e-3}, {"lr": 10.0}, {"lr": 3e-3}, {"lr": 2e-3}]
    out = TS.asha_vae_search(x_cal.astype(np.float32),
                             x_val.astype(np.float32), None, max_epochs=4,
                             reduction=2, min_epochs=1, seed=3,
                             base_config=BASE, configs=cohort, verbose=False,
                             device="cpu")
    assert out["rungs"] == [1, 2, 4]
    assert 1 in out["history"][0]["killed"]
    assert out["trials"][1]["epochs"] == 1
    assert out["total_epochs"] == 4 * 1 + 2 * 1 + 1 * 2
    assert out["best_config"]["lr"] != 10.0
    assert np.isfinite(out["best_value"])
    # deterministic under the seed
    again = TS.asha_vae_search(x_cal.astype(np.float32),
                               x_val.astype(np.float32), None, max_epochs=4,
                               reduction=2, min_epochs=1, seed=3,
                               base_config=BASE, configs=cohort,
                               verbose=False, device="cpu")
    assert again["best_value"] == out["best_value"]
    assert again["history"] == out["history"]


def test_asha_survivors_resume_their_exact_trajectory():
    """A survivor trained over rungs 2 + 2 (re-stacked with another
    survivor) reaches the best value of the same config trained 4 epochs
    alone by ``train_vae_vmapped`` with its trial seed."""
    x_cal, x_val = _data()
    cohort = [{"lr": 2e-3}, {"lr": 1e-4}, {"lr": 3e-3}]
    out = TS.asha_vae_search(x_cal, x_val, None, max_epochs=4, reduction=2,
                             min_epochs=2, seed=5, base_config=BASE,
                             configs=cohort, verbose=False, device="cpu")
    winner = out["trials"][out["history"][-1]["alive"][0]]
    alone = TS.train_vae_vmapped(
        TS.vae_from_config(x_cal.shape[1], BASE), x_cal, x_val,
        [winner["config"]["lr"]], [0.0], [1.0], epochs=4, batch_size=16,
        loss_type="euclidean", cfg_seeds=[TSt.config_seed(5, winner["id"])],
        spec_stats=TBd.spectral_stats(x_cal), device="cpu")
    assert winner["best_val"] == float(np.min(alone.val_losses))


def test_asha_validates_arguments():
    x = np.zeros((8, 16), np.float32)
    with pytest.raises(ValueError, match="reduction"):
        TS.asha_vae_search(x, x, n_trials=4, max_epochs=6, reduction=1,
                           min_epochs=2)
    with pytest.raises(ValueError, match="n_trials"):
        TS.asha_vae_search(x, x, n_trials=0)
    with pytest.raises(ValueError, match="min_epochs"):
        TS.asha_vae_search(x, x, max_epochs=6, min_epochs=9)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        TS.asha_vae_search(x, x, mesh=object())


# ---------------------------------------------------------------------------
# the runner and the Optuna adapters (tests/test_sweep.py's cases)
# ---------------------------------------------------------------------------


def _sweep_data(rng, n, length=48, shift=0.0):
    t = np.linspace(0, 1, length)
    base = np.sin(2 * np.pi * (3 + shift) * t) + shift
    return (rng.normal(1, 0.05, (n, 1)) * base
            + rng.normal(0, 0.02, (n, length))).astype(np.float32)


def test_run_vae_sweep_artifacts_and_resume(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    x_cal, x_val = _sweep_data(rng, 64), _sweep_data(rng, 24)
    x_test = np.concatenate([_sweep_data(rng, 32),
                             _sweep_data(rng, 32, shift=2.0)])
    y_test = np.repeat([0, 1], 32)
    configs = TS.grid_product(
        {"epochs": 3, "batch_size": 32, "latent_dim": 4, "conv_blocks": 2,
         "n_filters": 8, "hidden_fc": 32, "loss_type": "euclidean"},
        {"lr": [1e-3, 3e-3]})
    out = str(tmp_path / "sweep")
    res1 = TS.run_vae_sweep(configs, x_cal, x_val, x_test, y_test, out,
                            verbose=False, device="cpu")
    assert len(res1) == 2 and all("accuracy" in r for r in res1)
    for i in range(2):
        run = os.path.join(out, f"run_{i:04d}")
        for name in ("params.json", "losses.json", "metrics.json",
                     "model_bundle.msgpack"):
            assert os.path.exists(os.path.join(run, name)), name
    for name in ("all_params.json", "all_metrics.json"):
        assert os.path.exists(os.path.join(out, name))
    # run 1's bundle file holds run 1's trained model (its seed's run)
    model = TS.vae_from_config(48, configs[1])
    bundle = TBd.load_bundle(os.path.join(out, "run_0001",
                                          "model_bundle.msgpack"), model,
                             device="cpu")
    seq = TT.train_vae(TSt.seeded_vae(model, TSt.config_seed(42, 1)), x_cal,
                       x_val, TT.TrainConfig(epochs=3, batch_size=32, lr=3e-3,
                                             loss_type="euclidean"),
                       seed=TSt.config_seed(42, 1), device="cpu")
    for k, v in seq.bundle.state_dict.items():
        if "num_batches" not in k:
            torch.testing.assert_close(bundle.state_dict[k], v, rtol=1e-6,
                                       atol=1e-7, msg=k)
    # resume: the second call reads the metrics back and trains nothing
    monkeypatch.setattr(TT, "train_vae", None)
    res2 = TS.run_vae_sweep(configs, x_cal, x_val, x_test, y_test, out,
                            verbose=False, device="cpu")
    assert res2 == res1


def test_optuna_objective_wrapper_with_fake_trial():
    class FakeTrial:
        def __init__(self):
            self.calls = []

        def suggest_int(self, k, lo, hi):
            self.calls.append(("int", k, lo, hi))
            return lo

        def suggest_float(self, k, lo, hi, log=False):
            self.calls.append(("float", k, lo, hi, log))
            return lo

        def suggest_categorical(self, k, choices):
            self.calls.append(("cat", k, tuple(choices)))
            return choices[0]

    space = {"latent_dim": ("int", 4, 16), "lr": ("loguniform", 1e-4, 1e-2),
             "beta": ("uniform", 0.0, 2.0),
             "batch_size": ("categorical", [32, 64])}
    seen = {}
    obj = TS.optuna_objective(lambda cfg: seen.update(cfg) or 1.0, space)
    trial = FakeTrial()
    assert obj(trial) == 1.0
    assert seen == {"latent_dim": 4, "lr": 1e-4, "beta": 0.0,
                    "batch_size": 32}
    assert ("float", "lr", 1e-4, 1e-2, True) in trial.calls
    with pytest.raises(ValueError):
        TS.optuna_objective(lambda c: 0.0, {"z": ("nope", 1)})(FakeTrial())
    try:
        import optuna  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="random_search"):
            TS.run_optuna_study(lambda c: 0.0, space, n_trials=1)


def test_run_optuna_study_executes_against_fake_optuna(monkeypatch):
    """The live adapter over ``tests/fake_optuna.py`` gives the JAX
    package's study, trial for trial."""
    import fake_optuna

    monkeypatch.setitem(sys.modules, "optuna", fake_optuna)
    space = {"x": ("uniform", -1.0, 1.0), "k": ("int", 1, 4),
             "lr": ("loguniform", 1e-4, 1e-1), "c": ("categorical", [0, 1])}
    objective = lambda cfg: -(cfg["x"] - 0.3) ** 2
    for direction in ("maximize", "minimize"):
        study = TS.run_optuna_study(objective, space, n_trials=12, seed=7,
                                    direction=direction)
        ref = JS.run_optuna_study(objective, space, n_trials=12, seed=7,
                                  direction=direction)
        assert len(study.trials) == 12
        assert [t.params for t in study.trials] == [t.params
                                                    for t in ref.trials]
        assert study.best_value == ref.best_value
        vals = [t.value for t in study.trials if t.state == "COMPLETE"]
        assert study.best_value == (max if direction == "maximize"
                                    else min)(vals)


def test_pruning_report_drives_fake_median_pruner(monkeypatch):
    import fake_optuna

    monkeypatch.setitem(sys.modules, "optuna", fake_optuna)
    study = fake_optuna.create_study(
        direction="minimize",
        pruner=fake_optuna.MedianPruner(n_startup_trials=1,
                                        n_warmup_steps=1))
    trajectories = {0: [5.0, 4.0, 3.0, 2.0, 1.0],
                    1: [5.0, 4.5, 4.4, 4.3, 4.2]}

    def objective(trial):
        report = TS.pruning_report(trial)
        best = float("inf")
        for epoch, v in enumerate(trajectories[trial.number]):
            best = min(best, v)
            if report(epoch, v, v):
                raise fake_optuna.TrialPruned()
        return best

    study.optimize(objective, n_trials=2)
    assert study.trials[0].state == "COMPLETE"
    assert study.trials[1].state == "PRUNED"
    assert max(study.trials[1].intermediate_values) == 1
    assert study.best_value == 1.0


def test_pruning_report_stops_the_blocked_trainer():
    """A fake trial that prunes at its third report cuts the port's
    ``train_vae_blocked`` at epoch 2, with the reported best bundle."""
    class Trial:
        def __init__(self):
            self.reported = []

        def report(self, value, step):
            self.reported.append((step, value))

        def should_prune(self):
            return len(self.reported) >= 3

    x_cal, x_val = _data()
    trial = Trial()
    r = TT.train_vae_blocked(TV.ConvVAE1D(**VAE_SMALL), x_cal, x_val,
                             TT.TrainConfig(epochs=50, batch_size=16,
                                            lr=2e-3, loss_type="euclidean"),
                             seed=0, block_epochs=2,
                             report=TS.pruning_report(trial), device="cpu")
    assert len(r.val_losses) == 3
    assert [s for s, _ in trial.reported] == [0, 1, 2]
    assert r.bundle is not None and r.best_epoch <= 2
