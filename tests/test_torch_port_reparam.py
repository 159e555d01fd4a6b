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
