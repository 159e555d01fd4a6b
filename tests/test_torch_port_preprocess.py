"""The port's spectral preprocessing (``ocm_tpu_torch.ops.preprocess``)
against ``ocm_tpu.ops.preprocess``, float64 on the CPU.

The Savitzky-Golay operator is built in numpy float64 by both packages
from the same formulas, so it must be equal exactly; the filtered spectra
(one product with it) agree to 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.ops import preprocess as JP
from ocm_tpu_torch.ops import preprocess as TP
from torch_port_data import LENGTH, make_data

RTOL = 1e-12


def _spectra():
    cals, xs = make_data(seed=4)
    return np.concatenate([cals.reshape(-1, LENGTH), xs[:50]]) + 3.0


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("args", [(5, 2, 1), (15, 2, 1), (7, 3, 0), (9, 4, 2),
                                  (5, 2, 1, 0.5)], ids=str)
def test_savgol_matrix_equals_jax(args):
    np.testing.assert_array_equal(TP.savgol_matrix(LENGTH, *args),
                                  JP.savgol_matrix(LENGTH, *args))
    np.testing.assert_array_equal(TP.savgol_coeffs(*args),
                                  JP.savgol_coeffs(*args))


@pytest.mark.parametrize("args", [(5, 2, 1), (15, 2, 1), (9, 4, 2)], ids=str)
def test_savgol_filter_matches_jax(args):
    x = _spectra()
    _close(TP.savgol_filter(torch.as_tensor(x), *args),
           JP.savgol_filter(jnp.asarray(x), *args))


def test_savgol_filter_dtype_and_validation():
    x = torch.as_tensor(_spectra(), dtype=torch.float32)
    assert TP.savgol_filter(x, 5, 2, 1).dtype == torch.float32
    assert TP.savgol_filter(x, 5, 2, 1, dtype=torch.float64).dtype == \
        torch.float64
    with pytest.raises(ValueError, match="polyorder"):
        TP.savgol_coeffs(3, 3)
    with pytest.raises(ValueError, match="window_length"):
        TP.savgol_matrix(4, 5, 2)


def test_snv_savgol_matches_jax():
    x = _spectra()
    _close(TP.snv_savgol(torch.as_tensor(x), 5, 2, 1),
           JP.snv_savgol(jnp.asarray(x), 5, 2, 1))
    got = TP.snv(torch.as_tensor(x))
    _close(got, JP.snv(jnp.asarray(x)))
    np.testing.assert_allclose(got.mean(-1).numpy(), 0.0, atol=1e-12)


def test_standardize_and_minmax_match_jax():
    x = _spectra()
    mean, std = x.mean(0), x.std(0)
    _close(TP.standardize(torch.as_tensor(x), torch.as_tensor(mean),
                          torch.as_tensor(std)),
           JP.standardize(jnp.asarray(x), jnp.asarray(mean),
                          jnp.asarray(std)))
    _close(TP.minmax_scale(torch.as_tensor(x)),
           JP.minmax_scale(jnp.asarray(x)))
