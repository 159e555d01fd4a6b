"""The port's VAE decision layer (``ocm_tpu_torch.models.vae_decision``,
variants 2-4) against ``ocm_tpu.models.vae_decision``, float64 on the CPU.

Both packages score one untrained bundle (JAX ``init_vae`` weights with
random BatchNorm statistics, carried across by ``ocm_bundle_from_numpy``)
on seeded spectra.  Tolerance 1e-8 relative: f64 convolutions summed in
another order, eigh-based pseudo-inverses and bisected chi^2 quantiles;
accept vectors must be equal.

The stochastic forward is compared with JAX's own noise: the JAX model's
``reparameterize`` method with the same key is the root module's first
``make_rng('reparam')``, as in its ``__call__``, so applying it to
(mu, logvar) = (0, 0) returns the eps that ``bundle.forward`` draws; the
port is handed that eps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.models import bundle as JBd
from ocm_tpu.models import vae as JV
from ocm_tpu.models import vae_decision as JD
from ocm_tpu.stats import qhf as JQ
from ocm_tpu_torch.models import bundle as TBd
from ocm_tpu_torch.models import vae_decision as TD
from ocm_tpu_torch.ops import kernels as TK
from ocm_tpu_torch.stats import qhf as TQ
from torch_port_data import VAE_SMALL, vae_bundle_pair, vae_classes

RTOL, ATOL = 1e-8, 1e-10
LOSSES = ["cosine", "bce", "euclidean", "bce_prob"]
FIELDS = ("latent_mean", "latent_cov_inv", "threshold", "threshold_q",
          "threshold_h", "threshold_f")


def _close(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.fixture(scope="module")
def setup():
    (x_cal,), x_test = vae_classes(1)
    jmodel, jb, tmodel, tb = vae_bundle_pair(x_cal)
    # decisions need fitted statistics: the JAX fit, carried across
    jfit = JD.fit_thresholds(jmodel, jb, x_cal, loss_type="euclidean")
    tfit = tb._replace(**{f: torch.as_tensor(np.array(getattr(jfit, f)))
                          for f in FIELDS})
    return dict(x_cal=x_cal, x_test=x_test, jmodel=jmodel, jb=jb,
                tmodel=tmodel, tb=tb, jfit=jfit, tfit=tfit)


def _jax_eps(jmodel, jb, n, key):
    """The eps JAX's ``bundle.forward`` draws from ``key``."""
    zero = jnp.zeros((n, VAE_SMALL["latent_dim"]), jnp.float64)
    return np.asarray(jmodel.apply(JBd._variables(jb), zero, zero,
                                   method=JV.ConvVAE1D.reparameterize,
                                   rngs={"reparam": key}))


def test_latent_d2_matches_jax(setup):
    s = setup
    _close(TD.latent_d2(s["tmodel"], s["tfit"], s["x_test"]),
           JD.latent_d2(s["jmodel"], s["jfit"], jnp.asarray(s["x_test"])),
           "d2")


@pytest.mark.parametrize("loss", LOSSES)
def test_reconstruction_errors_match_jax(setup, loss):
    s = setup
    ref = JD.reconstruction_errors(s["jmodel"], s["jb"],
                                   jnp.asarray(s["x_test"]), loss)
    got = TD.reconstruction_errors(s["tmodel"], s["tb"], s["x_test"], loss)
    for g, r, what in zip(got, ref, ("q", "mu", "x_rec")):
        _close(g, r, f"{loss} {what}")


@pytest.mark.parametrize("mode", ["euclidean", "cosine"])
def test_compute_rec_error_matches_jax(mode):
    rng = np.random.default_rng(3)
    x, x_rec = rng.normal(size=(2, 20, 9))
    _close(TD.compute_rec_error(x, x_rec, mode, device="cpu"),
           JD.compute_rec_error(x, x_rec, mode), mode)
    with pytest.raises(ValueError, match="unknown mode"):
        TD.compute_rec_error(x, x_rec, "l1", device="cpu")


@pytest.mark.parametrize("held_out", [False, True], ids=["cal", "held_out"])
@pytest.mark.parametrize("loss", LOSSES)
def test_fit_thresholds_matches_jax(setup, loss, held_out):
    s = setup
    x_thr = s["x_test"][:30] if held_out else None
    ref = JD.fit_thresholds(s["jmodel"], s["jb"], s["x_cal"], loss,
                            x_threshold=x_thr)
    got = TD.fit_thresholds(s["tmodel"], s["tb"], s["x_cal"], loss,
                            x_threshold=x_thr)
    for f in FIELDS:
        _close(getattr(got, f), getattr(ref, f), f)
    assert got.state_dict is s["tb"].state_dict


@pytest.mark.parametrize("variant", ["d2", "d2_q", "f", "f_calibrated",
                                     "full", "full_moments"])
def test_decisions_match_jax(setup, variant):
    s = setup
    jm, jb, tm, tb = s["jmodel"], s["jfit"], s["tmodel"], s["tfit"]
    xj, xt = jnp.asarray(s["x_test"]), s["x_test"]
    if variant == "d2":
        ref, got = JD.decide_d2(jm, jb, xj), TD.decide_d2(tm, tb, xt)
    elif variant == "d2_q":
        ref = JD.decide_d2_q(jm, jb, xj, "euclidean")
        got = TD.decide_d2_q(tm, tb, xt, "euclidean")
    elif variant.startswith("f"):
        jcal = tcal = None
        if variant == "f_calibrated":
            mu, _ = JBd.encode(jm, jb, jnp.asarray(s["x_cal"]))
            rec = JBd.decode(jm, jb, mu)
            jcal = JQ.qhf_fit(JBd.standardize(jb, jnp.asarray(s["x_cal"])),
                              JBd.standardize(jb, rec), mu)
            tcal = TQ.QHFCalibration(*(torch.as_tensor(np.array(a))
                                       for a in jcal))
        ref = JD.decide_f(jm, jb, xj, calibration=jcal)
        got = TD.decide_f(tm, tb, xt, calibration=tcal)
    else:
        moments = (3.0, 1.5, 40.0, 12.0) if variant == "full_moments" \
            else None
        ref = JD.decide_full_distance(jm, jb, xj, moments=moments)
        got = TD.decide_full_distance(tm, tb, xt, moments=moments)
    np.testing.assert_array_equal(got.accept.numpy(), np.asarray(ref.accept))
    assert 0 < got.accept.sum() < len(xt) or variant.startswith("full")
    _close(got.d2, ref.d2, "d2")
    _close(got.q, ref.q, "q")


def test_jax_noise_extraction_reproduces_its_forward(setup):
    """The eps read off ``reparameterize`` is the one ``forward`` draws."""
    s = setup
    key = jax.random.key(11)
    x = jnp.asarray(s["x_cal"][:12])
    eps = _jax_eps(s["jmodel"], s["jb"], 12, key)
    x_rec, mu, _ = JBd.forward(s["jmodel"], s["jb"], x, key)
    lv = JBd.encode(s["jmodel"], s["jb"], x)[1]
    ref = JBd.decode(s["jmodel"], s["jb"], mu + eps * jnp.exp(0.5 * lv))
    np.testing.assert_allclose(np.asarray(x_rec), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("loss", ["cosine", "bce"])
def test_stochastic_calibration_matches_jax(setup, loss):
    s = setup
    key = jax.random.key(4)
    eps = _jax_eps(s["jmodel"], s["jb"], len(s["x_cal"]), key)
    ref_q = JD.reconstruction_errors(s["jmodel"], s["jb"],
                                     jnp.asarray(s["x_cal"]), loss, rng=key)
    got_q = TD.reconstruction_errors(s["tmodel"], s["tb"], s["x_cal"], loss,
                                     eps=eps)
    for g, r, what in zip(got_q, ref_q, ("q", "mu", "x_rec")):
        _close(g, r, what)
    ref = JD.fit_thresholds(s["jmodel"], s["jb"], s["x_cal"], loss, rng=key)
    got = TD.fit_thresholds(s["tmodel"], s["tb"], s["x_cal"], loss, eps=eps)
    for f in FIELDS:
        _close(getattr(got, f), getattr(ref, f), f)


def test_rng_calibration_draws_the_kernel_noise(setup):
    """``rng`` draws one 64-bit seed on the host; the noise is K5's (its
    plain twin on the CPU), so the result is that of passing it as eps."""
    s = setup
    n, k = len(s["x_cal"]), VAE_SMALL["latent_dim"]
    seed = TBd.draw_seed(torch.Generator().manual_seed(9))
    eps = TK.philox_normal_plain(n, k, seed, dtype=torch.float64)
    got = TD.fit_thresholds(s["tmodel"], s["tb"], s["x_cal"],
                            rng=torch.Generator().manual_seed(9))
    ref = TD.fit_thresholds(s["tmodel"], s["tb"], s["x_cal"], eps=eps)
    for f in FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(ref, f),
                                   rtol=0, atol=0)
    det = TD.fit_thresholds(s["tmodel"], s["tb"], s["x_cal"])
    assert not torch.equal(det.threshold_q, got.threshold_q)
    with pytest.raises(ValueError, match="x_threshold"):
        TD.fit_thresholds(s["tmodel"], s["tb"], s["x_cal"], eps=eps,
                          x_threshold=s["x_test"])


def test_decisions_keep_no_graph_and_leave_the_model(setup):
    """Entry points run under inference mode on a bound copy: no output
    requires grad, and the caller's module is not reloaded."""
    s = setup
    tm = s["tmodel"]
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    out = TD.decide_d2_q(tm, s["tfit"], s["x_test"], "euclidean")
    assert not out.d2.requires_grad and torch.is_inference(out.d2)
    bound = TBd.bind(tm, s["tfit"])
    assert TBd.bind(bound, s["tfit"]) is bound
    assert not any(p.requires_grad for p in bound.parameters())
    again = TD.decide_d2_q(bound, s["tfit"], s["x_test"], "euclidean")
    torch.testing.assert_close(again.q, out.q, rtol=0, atol=0)
    for key, val in tm.state_dict().items():
        assert torch.equal(val, before[key]), key
