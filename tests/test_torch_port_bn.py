"""The port's fused BatchNorm + activation (``ocm_tpu_torch.ops.bn``)
against ``ocm_tpu.ops.bn``, float64 on the CPU.

JAX's ``fused_bn_act`` runs its Pallas kernels in interpret mode on
channels-last ``(B, L, C)``; the port runs the plain twins of kernels K2/K3
on ``(B, C, L)``.  The same seeded inputs go to both with the channel axis
moved.  Tolerance: 1e-10 relative (f64; only the summation order differs).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.ops import bn as JB
from ocm_tpu_torch.ops import bn as TB
from torch_port_data import eval_kernel_on_cpu

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


# --- the eval-mode conv epilogue: bn_act_eval (K9 on the card) --------------

EVAL_SHAPES = [(4, 8, 16), (3, 5, 7)]        # L % 4 == 0, and not


def _eval_inputs(shape, dtype, seed=6):
    """x (B, C, L), conv bias, running mean and var, gamma, beta."""
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=gen, dtype=dtype) * 1.5 + 0.3
    vecs = [torch.randn(c, generator=gen, dtype=dtype) * 0.5,
            torch.randn(c, generator=gen, dtype=dtype) * 0.3,
            torch.rand(c, generator=gen, dtype=dtype) + 0.5,
            torch.rand(c, generator=gen, dtype=dtype) + 0.5,
            torch.randn(c, generator=gen, dtype=dtype) * 0.5]
    return (x, *vecs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("shape", EVAL_SHAPES, ids=str)
@pytest.mark.parametrize("act", JB.ACTS)
def test_bn_act_eval_plain_is_the_eager_chain(act, shape, dtype):
    """On a CPU tensor ``bn_act_eval`` is its plain twin, the eager chain
    x + conv bias then ``bn_act_normalize``, in a new tensor."""
    x, bias, mean, var, gamma, beta = _eval_inputs(shape, dtype)
    ref = TB.bn_act_normalize(x + bias[:, None], mean, var, gamma, beta,
                              1e-5, act)
    src = x.clone()
    got = TB.bn_act_eval(src, bias, mean, var, gamma, beta, 1e-5, act)
    assert torch.equal(got, ref) and torch.equal(src, x)
    assert torch.equal(TB.bn_act_eval_plain(x, bias, mean, var, gamma, beta,
                                            1e-5, act), ref)
    # no bias: nothing added
    assert torch.equal(TB.bn_act_eval(x, None, mean, var, gamma, beta, 1e-5,
                                      act),
                       TB.bn_act_normalize(x, mean, var, gamma, beta, 1e-5,
                                           act))


def _autocast():
    return torch.autocast("cpu", dtype=torch.bfloat16)


# case -> (how x and the parameters are made, the context of the call,
# whether K9 has the epilogue to compute on the card)
EVAL_CASES = {
    "f32": (lambda a: a, None, True),
    "no_grad_mode": (lambda a: a, torch.no_grad, True),
    "grad": (lambda a: a, None, False),
    "f64": (lambda a: a.double(), None, False),
    # any layout: the launch refuses a strided view (a card test)
    "strided": (lambda a: a.transpose(1, 2).contiguous().transpose(1, 2),
                None, True),
    "autocast": (lambda a: a, _autocast, False),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_bn_act_eval_takes_the_kernel_only_where_it_applies(monkeypatch,
                                                            case):
    """``eval_kernel_applies`` never gives a CPU tensor to K9; asked for
    the same tensors as on the card (``eval_kernel_on_cpu``), it takes
    float32 with nothing for autograd to record, and leaves float64,
    autocast and a graph to record to the eager chain.  ``bn_act_eval``
    of the CPU tensor is the twin in every case."""
    make, context, fused = EVAL_CASES[case]
    x, bias, mean, var, gamma, beta = _eval_inputs((3, 4, 10), torch.float32)
    x, bias, mean, var, gamma, beta = (make(t) if t.dim() == 3 else
                                       t.to(make(x).dtype) for t in
                                       (x, bias, mean, var, gamma, beta))
    if case in ("grad", "no_grad_mode"):
        gamma.requires_grad_()
    params = (bias, mean, var, gamma, beta)
    ref = TB.bn_act_eval_plain(x, *params, 1e-5, "elu")
    with (context or contextlib.nullcontext)():
        on_cpu = TB.eval_kernel_applies(x, *params)
        got = TB.bn_act_eval(x, *params, 1e-5, "elu")
        eval_kernel_on_cpu(monkeypatch)
        on_card = TB.eval_kernel_applies(x, *params)
    assert not on_cpu and on_card == fused
    assert torch.equal(got.detach(), ref.detach())
    assert got.requires_grad == (case == "grad")


def test_bn_act_eval_fused_refuses_cpu_tensors():
    x, bias, mean, var, gamma, beta = _eval_inputs((2, 3, 4), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        TB.bn_act_eval_fused(x, bias, mean, gamma, beta)
