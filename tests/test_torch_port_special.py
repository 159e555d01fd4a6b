"""Parity of the port's special functions (``ocm_tpu_torch.ops.special``)
with ``ocm_tpu.ops.special`` and scipy, in float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import scipy.stats as st
import torch

from ocm_tpu.ops import special as J
from ocm_tpu_torch.ops import special as S

# dof pairs: the bench's F(k=10, n-k=690) as Beta(5, 345), small dofs, and
# strongly asymmetric ones
A = np.array([5.0, 0.5, 1.0, 2.5, 345.0, 50.0, 0.5])
B = np.array([345.0, 0.5, 3.0, 4.0, 5.0, 5000.0, 345.0])
P = np.array([1e-6, 1e-3, 0.05, 0.5, 0.95, 0.99, 1 - 1e-6])
X = np.array([1e-8, 1e-4, 0.01, 0.2, 0.5, 0.8, 0.99, 1 - 1e-6])
DFN = np.array([10.0, 1.0, 3.0, 10.0, 25.0])
DFD = np.array([690.0, 5.0, 117.0, 20.0, 2000.0])
DF = np.array([1.0, 2.0, 10.0, 14.5, 100.0, 690.0])


def _grid(*axes):
    return [g.ravel() for g in np.meshgrid(*axes, indexing="ij")]


def _pairs(first, second, third):
    """(first[i], second[i]) pairs crossed with every value of ``third``."""
    i, z = _grid(np.arange(len(first)), third)
    return first[i.astype(int)], second[i.astype(int)], z


def _resolved(shape, p):
    """Where the reference's 36 halvings + 10 Newton steps resolve the
    quantile to 1e-9.  Below p = 1e-5 with a first shape parameter <= 0.5
    the root sits near 0 where the cdf grows like x^a; Newton leaves the
    bracket and both packages stop at the same bisection midpoint
    (chi2_ppf(1e-6, 1): 1.5178e-12 in both vs scipy's 1.5708e-12)."""
    return (p >= 1e-5) | (shape > 0.5)


def _cases():
    """name -> (args, port fn, JAX fn, scipy fn, where scipy is matched)."""
    a, b, x = _pairs(A, B, X)
    ap, bp, p = _pairs(A, B, P)
    dfn, dfd, pf = _pairs(DFN, DFD, P)
    df, pc = _grid(DF, P)
    ga = df / 2.0
    return {
        "betainc": ((a, b, x), S.betainc, J.betainc, sp.betainc,
                    np.ones_like(x, bool)),
        "betaincinv": ((ap, bp, p), S.betaincinv, J.betaincinv,
                       sp.betaincinv, _resolved(ap, p)),
        "f_ppf": ((pf, dfn, dfd), S.f_ppf, J.f_ppf, st.f.ppf,
                  _resolved(dfn / 2.0, pf)),
        "chi2_ppf": ((pc, df), S.chi2_ppf, J.chi2_ppf, st.chi2.ppf,
                     _resolved(ga, pc)),
        "gammaincinv": ((ga, pc), S.gammaincinv, J.gammaincinv,
                        sp.gammaincinv, _resolved(ga, pc)),
    }


@pytest.mark.parametrize("name", ["betainc", "betaincinv", "f_ppf",
                                  "chi2_ppf", "gammaincinv"])
def test_special_matches_jax_and_scipy(name):
    args, port, ref, oracle, resolved = _cases()[name]
    got = port(*(torch.as_tensor(a) for a in args)).numpy()
    assert got.dtype == np.float64
    jax_val = np.asarray(ref(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, jax_val, rtol=1e-9, atol=0)
    assert resolved.mean() > 0.9
    np.testing.assert_allclose(got[resolved], oracle(*args)[resolved],
                               rtol=1e-9, atol=0)


def test_edges_and_cdfs():
    p = torch.tensor([0.0, 1.0], dtype=torch.float64)
    assert S.f_ppf(p, 10.0, 690.0).tolist() == [0.0, float("inf")]
    assert S.chi2_ppf(p, 4.0).tolist() == [0.0, float("inf")]
    assert S.betaincinv(2.0, 3.0, p).tolist() == [0.0, 1.0]
    x = torch.tensor([0.3, 1.8, 7.0], dtype=torch.float64)
    np.testing.assert_allclose(S.f_cdf(x, 10.0, 690.0).numpy(),
                               st.f.cdf(x.numpy(), 10, 690), rtol=1e-9)
    np.testing.assert_allclose(S.chi2_cdf(x, 3.0).numpy(),
                               st.chi2.cdf(x.numpy(), 3), rtol=1e-9)


def test_float32_stays_float32():
    v = S.f_ppf(0.95, torch.tensor(10.0), torch.tensor(690.0))
    assert v.dtype == torch.float32
    np.testing.assert_allclose(v.item(), st.f.ppf(0.95, 10, 690), rtol=1e-5)
