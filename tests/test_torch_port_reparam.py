"""The port's fused reparameterize + KL (kernel K4's wrapper
``reparam_kl`` and its autograd form ``fused_reparam_kl``) against
``ocm_tpu.ops.kernels``, float64 on the CPU.

JAX runs ``reparam_loss_pallas(eps=...)`` and ``fused_reparam_kl`` in
interpret mode; the port runs the plain twin.  Same seeded numpy inputs;
tolerance 1e-12 relative (f64, elementwise plus one row sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.ops import kernels as JK
from ocm_tpu_torch.ops import kernels as TK

RTOL, ATOL = 1e-12, 1e-13
# (N, k): the VAE's latent shape cut in N, ragged rows and a k above 32
SHAPES = [(8, 4), (13, 5), (64, 16), (7, 40)]


def _inputs(n, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, k)), rng.normal(-0.5, 0.8, size=(n, k)),
            rng.normal(size=(n, k)), rng.normal(size=(n, k)),
            rng.normal(size=n))


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reparam_kl_matches_pallas_kernel(shape):
    mu, lv, eps, _, _ = _inputs(*shape)
    z_r, kl_r = JK.reparam_loss_pallas(jnp.asarray(mu), jnp.asarray(lv),
                                       jnp.asarray(eps), interpret=True)
    z, kl = TK.reparam_kl(*(torch.tensor(a) for a in (mu, lv, eps)))
    _close(z, z_r, "z")
    _close(kl, kl_r, "kl")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fused_reparam_kl_gradients_match_jax(shape):
    mu, lv, eps, dz, dkl = _inputs(*shape, seed=1)

    def f(m, v):
        return JK.fused_reparam_kl(m, v, jnp.asarray(eps), True)

    (z_r, kl_r), vjp = jax.vjp(f, jnp.asarray(mu), jnp.asarray(lv))
    dmu_r, dlv_r = vjp((jnp.asarray(dz), jnp.asarray(dkl)))
    mt = torch.tensor(mu, requires_grad=True)
    vt = torch.tensor(lv, requires_grad=True)
    et = torch.tensor(eps, requires_grad=True)
    z, kl = TK.fused_reparam_kl(mt, vt, et)
    torch.autograd.backward((z, kl), (torch.tensor(dz), torch.tensor(dkl)))
    _close(z.detach(), z_r, "z")
    _close(kl.detach(), kl_r, "kl")
    _close(mt.grad, dmu_r, "dmu")
    _close(vt.grad, dlv_r, "dlogvar")
    assert et.grad is None     # eps gets no gradient, as in JAX (zeros)


def test_fused_reparam_kl_gradcheck():
    mu, lv, eps, _, _ = _inputs(5, 3, seed=2)
    mt = torch.tensor(mu, requires_grad=True)
    vt = torch.tensor(lv, requires_grad=True)
    et = torch.tensor(eps)
    assert torch.autograd.gradcheck(
        lambda m, v: TK.fused_reparam_kl(m, v, et), (mt, vt))


def test_kl_equals_the_losses_kl_divergence():
    """The train step's KL term (mean of K4's per-sample KL) is
    ``kl_divergence`` of the reference."""
    from ocm_tpu.models.vae import kl_divergence
    mu, lv, eps, _, _ = _inputs(64, 16, seed=3)
    _, kl = TK.reparam_kl(*(torch.tensor(a) for a in (mu, lv, eps)))
    _close(kl.mean(), kl_divergence(jnp.asarray(mu), jnp.asarray(lv)), "KL")


# --- kernel K5: the noise drawn in the kernel ------------------------------
#
# JAX's eps=None branch cannot be compared: its interpreter fills the
# random bits with a constant (ocm_tpu/ops/kernels.py:117-120).  So the
# port's noise is held to the Random123 Philox known answers and to N(0, 1)
# in distribution, and z/KL to the Pallas kernel handed that same noise.

# (counter, key, output) of Random123's philox4x32_10 known-answer tests
PHILOX_KAT = [((0, 0, 0, 0), (0, 0),
               (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
              ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
               (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD))]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT, ids=["zeros", "ones"])
def test_plain_philox_known_answers(counter, key, want):
    got = TK.philox4x32_plain(torch.tensor([counter], dtype=torch.int64), key)
    assert tuple(got[0].tolist()) == want


def test_sampled_noise_is_deterministic_and_keyed():
    a = TK.philox_normal_plain(50, 7, seed=2 ** 40 + 3, offset=1)
    np.testing.assert_array_equal(
        a, TK.philox_normal_plain(50, 7, seed=2 ** 40 + 3, offset=1))
    others = [TK.philox_normal_plain(50, 7, seed=2 ** 40 + 4, offset=1),
              TK.philox_normal_plain(50, 7, seed=2 ** 40 + 3, offset=2),
              TK.philox_normal_plain(50, 7, seed=3, offset=1)]
    for b in others:
        assert float(torch.corrcoef(torch.stack([a.flatten(),
                                                 b.flatten()]))[0, 1]) < 0.1
        assert not torch.equal(a, b)
    # element (row, col) depends on (seed, offset, row * k + col) only
    tall = TK.philox_normal_plain(100, 7, seed=2 ** 40 + 3, offset=1)
    np.testing.assert_array_equal(tall[:50], a)


def test_sampled_noise_is_standard_normal():
    from scipy import stats

    eps = TK.philox_normal_plain(10_000, 10, seed=17,
                                 dtype=torch.float64).numpy()
    flat = eps.ravel()
    assert abs(flat.mean()) < 0.01 and abs(flat.var() - 1.0) < 0.015
    assert stats.kstest(flat, "norm").statistic < 0.005
    # Box-Muller of 24-bit uniforms, u1 >= 1e-7
    assert np.abs(flat).max() <= np.sqrt(-2.0 * np.log(1e-7)) + 1e-12
    for a, b in ((eps[:, :-1], eps[:, 1:]), (eps[:-1], eps[1:])):
        assert abs(np.corrcoef(a.ravel(), b.ravel())[0, 1]) < 0.01


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reparam_kl_sample_matches_pallas_kernel_given_its_noise(shape):
    mu, lv, _, _, _ = _inputs(*shape, seed=4)
    z, kl, eps = TK.reparam_kl_sample_plain(torch.tensor(mu), torch.tensor(lv),
                                            seed=99, offset=5)
    z_r, kl_r = JK.reparam_loss_pallas(jnp.asarray(mu), jnp.asarray(lv),
                                       jnp.asarray(eps.numpy()),
                                       interpret=True)
    _close(z, z_r, "z")
    _close(kl, kl_r, "kl")
    z_w, kl_w = TK.reparam_kl_sample(torch.tensor(mu), torch.tensor(lv), 99, 5)
    assert torch.equal(z_w, z) and torch.equal(kl_w, kl)
