"""The port's fused BatchNorm + activation (``ocm_tpu_torch.ops.bn``)
against ``ocm_tpu.ops.bn``, float64 on the CPU.

JAX's ``fused_bn_act`` runs its Pallas kernels in interpret mode on
channels-last ``(B, L, C)``; the port runs the plain twins of kernels K2/K3
on ``(B, C, L)``.  The same seeded inputs go to both with the channel axis
moved.  Tolerance: 1e-10 relative (f64; only the summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.ops import bn as JB
from ocm_tpu_torch.ops import bn as TB

RTOL, ATOL = 1e-10, 1e-12
# (B, C, L): ragged in every axis (JAX pads C to 8 and B*L to 128)
SHAPES = [(4, 8, 16), (3, 5, 7), (2, 16, 33)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    b, c, l = shape
    x = rng.normal(0.3, 1.5, size=shape)
    gamma = rng.uniform(0.5, 1.5, size=c)
    beta = rng.normal(0, 0.5, size=c)
    dout = rng.normal(size=shape)
    return x, gamma, beta, dout


def _cl(a):
    """(B, C, L) -> JAX's channels-last (B, L, C), and back."""
    return np.swapaxes(np.asarray(a), 1, 2)


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _jax_ref(x, gamma, beta, dout, act):
    """out, mean, var and the VJP of out against dout, through the Pallas
    kernels in interpret mode."""
    xj = jnp.asarray(_cl(x))

    def f(xx, g, b):
        return JB.fused_bn_act(xx, g, b, 1e-5, act, interpret=True)

    (out, mean, var), vjp = jax.vjp(f, xj, jnp.asarray(gamma),
                                    jnp.asarray(beta))
    zeros = jnp.zeros_like(mean)
    dx, dg, db = vjp((jnp.asarray(_cl(dout)), zeros, zeros))
    return _cl(out), mean, var, _cl(dx), dg, db


@pytest.mark.parametrize("act", JB.ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fused_bn_act_matches_jax(shape, act):
    x, gamma, beta, dout = _inputs(shape)
    out_r, mean_r, var_r, dx_r, dg_r, db_r = _jax_ref(x, gamma, beta, dout,
                                                     act)
    xt = torch.tensor(x, requires_grad=True)
    gt = torch.tensor(gamma, requires_grad=True)
    bt = torch.tensor(beta, requires_grad=True)
    out, mean, var = TB.fused_bn_act(xt, gt, bt, 1e-5, act)
    assert not mean.requires_grad and not var.requires_grad
    out.backward(torch.tensor(dout))
    for got, ref, what in ((out, out_r, "out"), (mean, mean_r, "mean"),
                           (var, var_r, "var"), (xt.grad, dx_r, "dx"),
                           (gt.grad, dg_r, "dgamma"),
                           (bt.grad, db_r, "dbeta")):
        _close(got.detach(), ref, f"{what} {shape} {act}")


@pytest.mark.parametrize("act", JB.ACTS)
def test_plain_twins_match_jax_kernels(act):
    """The twins the card's kernels are held against, called directly."""
    x, gamma, beta, dout = _inputs((3, 6, 20), seed=1)
    out_r, mean_r, var_r, dx_r, dg_r, db_r = _jax_ref(x, gamma, beta, dout,
                                                     act)
    t = [torch.tensor(a) for a in (x, gamma, beta, dout)]
    out, mean, var = TB.bn_act_fwd_plain(t[0], t[1], t[2], 1e-5, act)
    dx, dg, db = TB.bn_act_bwd_plain(t[0], t[1], t[2], mean, var, t[3], 1e-5,
                                     act)
    for got, ref, what in ((out, out_r, "out"), (mean, mean_r, "mean"),
                           (var, var_r, "var"), (dx, dx_r, "dx"),
                           (dg, dg_r, "dgamma"), (db, db_r, "dbeta")):
        _close(got, ref, f"{what} {act}")


@pytest.mark.parametrize("act", JB.ACTS)
def test_normalize_and_act_grad_match_jax(act):
    x, gamma, beta, _ = _inputs((4, 5, 9), seed=2)
    rng = np.random.default_rng(3)
    mean, var = rng.normal(size=5), rng.uniform(0.2, 2.0, size=5)
    ref = JB.bn_act_normalize(jnp.asarray(_cl(x)), jnp.asarray(mean),
                              jnp.asarray(var), jnp.asarray(gamma),
                              jnp.asarray(beta), 1e-5, act)
    got = TB.bn_act_normalize(torch.tensor(x), torch.tensor(mean),
                              torch.tensor(var), torch.tensor(gamma),
                              torch.tensor(beta), 1e-5, act)
    _close(got, _cl(ref), f"normalize {act}")
    y = rng.normal(0, 2, size=50)
    _close(TB.act_grad(torch.tensor(y), act), JB.act_grad(jnp.asarray(y), act),
           f"act_grad {act}")


def test_stats_are_fast_variance_and_f32_at_least():
    x = torch.tensor(_inputs((5, 3, 11))[0], dtype=torch.float32)
    mean, var = TB.bn_act_stats(x.to(torch.bfloat16))
    assert mean.dtype == var.dtype == torch.float32
    m, v = JB.bn_act_stats(jnp.asarray(_cl(x.double().numpy())))
    m_t, v_t = TB.bn_act_stats(x.double())
    _close(m_t, m, "mean")
    _close(v_t, v, "var")
    assert torch.all(var >= 0)


@pytest.mark.parametrize("act", JB.ACTS)
def test_fused_bn_act_gradcheck(act):
    """The closed-form K3 backward is the derivative of the K2 forward."""
    x, gamma, beta, _ = _inputs((2, 3, 5), seed=4)
    args = [torch.tensor(a, requires_grad=True) for a in (x, gamma, beta)]
    assert torch.autograd.gradcheck(
        lambda *a: TB.fused_bn_act(*a, 1e-5, act)[0], args)


def test_unknown_activation_raises():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="unknown activation"):
        TB.fused_bn_act(x, torch.ones(3), torch.zeros(3), 1e-5, "relu")
