"""The port's VAE trainer (``ocm_tpu_torch.models.trainer``) against
``ocm_tpu.models.trainer``, on the CPU.

JAX's random streams cannot be replayed in torch, so the step parity tests
hand both sides the same batches and noise: one train step (loss,
gradients, BatchNorm running statistics) and a 3-step Adam trajectory, in
float64.  The JAX side drives ``model.apply(..., method=f, train=True,
mutable=['batch_stats'])`` with BatchNorm through the Pallas kernels in
interpret mode.  The trainer's own rules (blocked equals monolithic,
best-checkpoint selection with NaN and skipped validations) are checked on
the port's runs, the selection rule against JAX's ``epoch_scan``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocm_tpu.models import trainer as JT
from ocm_tpu.models import vae as JV
from ocm_tpu_torch.models import trainer as TT
from ocm_tpu_torch.models import vae as TV
from torch_port_data import VAE_SMALL, perturb_bn, vae_spectra

B = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's trainings here are tiny: torch's intra-op threads would
    only contend with the other test workers' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@functools.lru_cache(maxsize=None)
def _setup():
    jmodel = JV.ConvVAE1D(**VAE_SMALL, dtype=jnp.float64, bn_impl="fused")
    params, stats = (_f64(t) for t in JV.init_vae(jmodel, jax.random.key(0)))
    params, stats = perturb_bn(params, stats)
    x = vae_spectra(3 * B, VAE_SMALL["input_length"], seed=6)
    x = (x - x.mean(0)) / x.std(0)
    eps = np.random.default_rng(7).normal(size=(3, B, VAE_SMALL["latent_dim"]))
    return jmodel, params, stats, x.reshape(3, B, -1), eps


def _jax_fwd(mod, x, eps):
    mu, lv = mod.encode(x, train=True)
    return mod.decode(mu + eps * jnp.exp(0.5 * lv), train=True), mu, lv


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(loss_type, beta):
    """Jitted (loss, new batch stats), grads of one JAX step, compiled once
    per loss for the tests that share it."""
    jmodel = _setup()[0]

    def loss_fn(p, stats, xb, eps):
        (x_rec, mu, lv), mut = jmodel.apply(
            {"params": p, "batch_stats": stats}, xb, eps, method=_jax_fwd,
            mutable=["batch_stats"])
        total, _, _ = JV.beta_vae_loss(xb, x_rec, mu, lv, beta=beta,
                                       loss_type=loss_type)
        return total, mut["batch_stats"]
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port(params, stats):
    model = TV.ConvVAE1D(**VAE_SMALL).double()
    model.load_state_dict(TV.vae_state_dict_from_numpy(params, stats, model))
    return model


def _as_state(model, params, stats):
    """A flax (params, stats) tree in the port's state-dict layout (the
    carrier's transforms are linear, so they carry gradients as well)."""
    return {k: v.numpy() for k, v in
            TV.vae_state_dict_from_numpy(params, stats, model).items()}


@pytest.mark.parametrize("loss_type", ["bce", "cosine"])
def test_one_train_step_matches_jax(loss_type):
    _, params, stats, xs, eps = _setup()
    cfg = TT.TrainConfig(loss_type=loss_type, beta=0.8)
    (loss_r, stats_r), grads_r = _jax_value_and_grad(loss_type, cfg.beta)(
        params, stats, jnp.asarray(xs[0]), jnp.asarray(eps[0]))

    model = _port(params, stats).train()
    loss = TT.step_loss(model, cfg, torch.tensor(xs[0]), torch.tensor(eps[0]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_r), rtol=1e-10)
    ref = _as_state(model, _f64(grads_r), stats)
    # the absolute floor scales with the largest gradient: a conv bias
    # ahead of a BatchNorm has an exact gradient of 0, so both sides hold
    # only rounding there
    scale = max(np.abs(ref[name]).max() for name, _ in
                model.named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=1e-7,
                                   atol=1e-12 * scale, err_msg=name)
    ref_stats = _as_state(model, params, _f64(stats_r))
    for name, buf in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), ref_stats[name],
                                       rtol=1e-10, atol=1e-13, err_msg=name)


def test_three_adam_steps_track_jax():
    _, params, stats, xs, eps = _setup()
    cfg = TT.TrainConfig(loss_type="bce", beta=0.8, lr=1e-3)
    vg = _jax_value_and_grad(cfg.loss_type, cfg.beta)
    tx = JT.torch_adam(cfg.lr, cfg.weight_decay)

    @jax.jit
    def adam(g, opt_state, p):
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    opt_state = jax.jit(tx.init)(params)
    p, s, losses_r = params, stats, []
    for i in range(3):
        (loss, s), g = vg(p, s, jnp.asarray(xs[i]), jnp.asarray(eps[i]))
        p, opt_state = adam(g, opt_state, p)
        losses_r.append(float(loss))

    model = _port(params, stats)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    step = TT.make_train_step(model, opt, cfg)
    losses = [step(torch.tensor(xs[i]), torch.tensor(eps[i])).item()
              for i in range(3)]
    # step 1 sees identical parameters; later steps see Adam's updates,
    # which divide by sqrt(second moment) and so amplify the last bits of
    # near-zero gradients (tests/test_bn.py:187-190): a looser bound there
    np.testing.assert_allclose(losses[0], losses_r[0], rtol=1e-10)
    np.testing.assert_allclose(losses, losses_r, rtol=1e-6)
    ref = _as_state(model, _f64(p), _f64(s))
    for name, v in model.state_dict().items():
        if "num_batches" in name:
            assert int(v) == 3
            continue
        np.testing.assert_allclose(v.numpy(), ref[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _data(n=40, length=VAE_SMALL["input_length"]):
    x = vae_spectra(n, length, seed=8).astype(np.float32)
    return x, x[:12]


def _fresh():
    return TV.ConvVAE1D(**VAE_SMALL, dropout=0.1)


def _same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("block_epochs", [1, 2, 3])
def test_blocked_equals_monolithic(block_epochs):
    x, xv = _data()
    cfg = TT.TrainConfig(epochs=5, batch_size=16, loss_type="bce")
    mono = TT.train_vae(_fresh(), x, xv, cfg, seed=3, device="cpu")
    seen = []
    blk = TT.train_vae_blocked(_fresh(), x, xv, cfg, seed=3,
                               block_epochs=block_epochs, device="cpu",
                               report=lambda *a: seen.append(a) and False)
    np.testing.assert_array_equal(blk.train_losses, mono.train_losses)
    np.testing.assert_array_equal(blk.val_losses, mono.val_losses)
    assert blk.best_epoch == mono.best_epoch
    assert [e for e, _, _ in seen] == list(range(5))
    _same_state(blk.bundle.state_dict, mono.bundle.state_dict)
    _same_state(blk.final_state, mono.final_state)
    assert np.all(np.isfinite(mono.train_losses))


def test_resume_continues_the_same_run():
    x, xv = _data()
    cfg = TT.TrainConfig(epochs=4, batch_size=16, weight_decay=1e-2)
    mono = TT.train_vae(_fresh(), x, xv, cfg, seed=1, device="cpu")
    model = _fresh()
    first = TT.train_vae(model, x, xv, dataclasses.replace(cfg, epochs=2),
                         seed=1, device="cpu")
    rest = TT.train_vae(model, x, xv, dataclasses.replace(cfg, epochs=2),
                        seed=1, init_state=(first.final_state,
                                            first.final_opt_state),
                        epoch_offset=2, device="cpu")
    np.testing.assert_array_equal(
        np.concatenate([first.train_losses, rest.train_losses]),
        mono.train_losses)
    _same_state(rest.final_state, mono.final_state)


def _scripted_eval(losses, steps_per_epoch):
    """A make_eval_loss stand-in whose loss at global epoch e is
    ``losses[e]``; the epoch is read from the model's step count, so a
    resumed or re-run prefix sees the same script."""
    def factory(model, cfg, spec=None):
        def eval_loss(x_std, eps):
            bn = model.encoder_conv[1].num_batches_tracked
            return torch.tensor(losses[int(bn) // steps_per_epoch - 1])
        return eval_loss
    return factory


def _jax_best_epoch(losses):
    """JAX's in-scan best-epoch rule (``epoch_scan``) on a scripted loss
    sequence: a counter stands in for the parameters."""
    cfg = JT.TrainConfig(epochs=len(losses))
    table = jnp.asarray(losses)

    def step_fn(p, bs, os, xb, rng):
        return p + 1, bs, os, jnp.zeros(())

    def eval_fn(p, bs, xv, rng):
        return table[p - 1]

    out = JT.epoch_scan(cfg, 1, 0, jnp.zeros((1, 1)), jnp.zeros((1, 1)),
                        step_fn, eval_fn, jnp.asarray(0), {}, (),
                        jax.random.key(0))
    return int(out[5])


# NaN and skipped (inf) validations must never become the best epoch
SCRIPTS = [[np.nan, 5.0, 7.0, np.nan, 3.0, 3.0, np.inf],
           [np.nan, np.nan, np.nan], [4.0, 2.0, np.nan, 2.0, 1.0]]


@pytest.mark.parametrize("script", SCRIPTS, ids=str)
def test_best_checkpoint_rule_matches_jax(monkeypatch, script):
    x, xv = _data(n=16)
    cfg = TT.TrainConfig(epochs=len(script), batch_size=16)
    monkeypatch.setattr(TT, "make_eval_loss", _scripted_eval(script, 1))
    r = TT.train_vae(_fresh(), x, xv, cfg, seed=0, device="cpu")
    np.testing.assert_array_equal(r.val_losses, script)
    assert r.best_epoch == _jax_best_epoch(script)
    blk = TT.train_vae_blocked(_fresh(), x, xv, cfg, seed=0, block_epochs=2,
                               device="cpu")
    finite = np.isfinite(script)
    if finite.any():
        assert blk.best_epoch == int(np.nanargmin(np.where(
            finite, script, np.nan)))
    else:
        assert blk.bundle is None and blk.best_epoch == 0


def test_pruned_block_recovers_the_reported_best(monkeypatch):
    """A prune inside a block whose own best lies after the cut: the
    bundle is the reported best epoch's, re-run from the block's entry."""
    x, xv = _data(n=16)
    script = [4.0, 2.0]
    monkeypatch.setattr(TT, "make_eval_loss", _scripted_eval(script, 1))
    cfg = TT.TrainConfig(epochs=2, batch_size=16)
    blk = TT.train_vae_blocked(_fresh(), x, xv, cfg, seed=0, block_epochs=2,
                               device="cpu", report=lambda e, t, v: True)
    assert blk.best_epoch == 0 and len(blk.val_losses) == 1
    one = TT.train_vae(_fresh(), x, xv, dataclasses.replace(cfg, epochs=1),
                       seed=0, device="cpu")
    _same_state(blk.bundle.state_dict, one.bundle.state_dict)


def test_val_every_skips_report_inf_and_raw_loss_space():
    x, xv = _data()
    cfg = TT.TrainConfig(epochs=4, batch_size=16, val_every=2,
                         loss_space="raw", loss_type="euclidean")
    r = TT.train_vae(_fresh(), x, xv, cfg, seed=0, device="cpu")
    assert np.isinf(r.val_losses[[0, 2]]).all()
    assert np.isfinite(r.val_losses[[1, 3]]).all()
    assert r.best_epoch in (1, 3)


def test_batch_indices_wrap_the_permutation():
    gen = torch.Generator().manual_seed(0)
    idx = TT.batch_indices(gen, 10, 4, "cpu")
    assert idx.shape == (3, 4)
    flat = idx.flatten()
    assert sorted(flat[:10].tolist()) == list(range(10))
    assert flat[10:].tolist() == flat[:2].tolist()
