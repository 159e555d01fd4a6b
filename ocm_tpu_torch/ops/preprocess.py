"""Spectral preprocessing (port of ``ocm_tpu/ops/preprocess.py``).

Row-wise SNV and Savitzky-Golay filtering, as the reference's scripts
preprocess (SNV then SavGol(5, 2, deriv=1)).  A Savitzky-Golay filter with
scipy's default ``mode='interp'`` edges is a linear map of each spectrum,
so it is one dense (L, L) operator built on the host in float64
(``savgol_matrix``) and applied as one product, ``x @ W.T``, in the
input's dtype with full f32 products (no TF32).

``savgol_coeffs`` and ``savgol_matrix`` are this package's own copies of
the reference's numpy functions.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ocm_tpu_torch.ops.linalg import full_f32_matmul


def snv(x, eps: float = 1e-8):
    """Standard Normal Variate: each spectrum centered and scaled by its
    population std (ddof 0) plus ``eps``."""
    mean = x.mean(-1, keepdim=True)
    std = x.std(-1, correction=0, keepdim=True)
    return (x - mean) / (std + eps)


def standardize(x, mean, std):
    """Per-wavelength standardization."""
    return (x - mean) / std


def minmax_scale(x, eps: float = 1e-8):
    """Per-spectrum min-max scaling to [0, 1]."""
    x_min = x.amin(-1, keepdim=True)
    x_max = x.amax(-1, keepdim=True)
    return ((x - x_min) / (x_max - x_min + eps)).clamp(0.0, 1.0)


@functools.lru_cache(maxsize=64)
def savgol_coeffs(window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0) -> np.ndarray:
    """SG convolution coefficients; matches scipy.signal.savgol_coeffs.

    Least-squares fit of a degree-``polyorder`` polynomial on the centered
    window, evaluated as the ``deriv``-th derivative at the window center.
    """
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    half = (window_length - 1) // 2
    t = np.arange(-half, window_length - half, dtype=np.float64)
    order = np.arange(polyorder + 1).reshape(-1, 1)
    a = t ** order                                   # (polyorder + 1, window)
    y = np.zeros(polyorder + 1)
    y[deriv] = math.factorial(deriv) / (delta ** deriv)
    coeffs, *_ = np.linalg.lstsq(a.T, np.eye(window_length), rcond=None)
    return (coeffs.T @ y)[::-1]      # scipy's (convolution) order


@functools.lru_cache(maxsize=64)
def savgol_matrix(n: int, window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0) -> np.ndarray:
    """Dense (n, n) operator equal to ``scipy.signal.savgol_filter(...,
    mode='interp', axis=-1)`` on a length-``n`` signal: interior rows hold
    the SG stencil, the first and last ``window_length // 2`` rows the
    polynomial fits to the terminal windows that ``mode='interp'`` makes."""
    if window_length > n:
        raise ValueError("window_length must not exceed signal length")
    half = window_length // 2
    w = np.zeros((n, n), dtype=np.float64)
    c = savgol_coeffs(window_length, polyorder, deriv, delta)[::-1]
    for i in range(half, n - half):
        w[i, i - half:i + half + 1] = c

    t = np.arange(window_length, dtype=np.float64)
    v = t.reshape(-1, 1) ** np.arange(polyorder + 1)  # (window, polyorder+1)
    pinv_v = np.linalg.pinv(v)

    def deriv_row(positions: np.ndarray) -> np.ndarray:
        rows = np.zeros((len(positions), polyorder + 1))
        for k in range(deriv, polyorder + 1):
            fac = math.factorial(k) / math.factorial(k - deriv)
            rows[:, k] = fac * positions ** (k - deriv) / (delta ** deriv)
        return rows

    w[:half, :window_length] = deriv_row(t[:half]) @ pinv_v
    w[n - half:, n - window_length:] = \
        deriv_row(t[window_length - half:]) @ pinv_v
    return w


@functools.lru_cache(maxsize=16)
def _operator_t(n, window_length, polyorder, deriv, delta, dtype, device):
    """``savgol_matrix(...).T`` as a tensor, placed once per device and
    dtype (a serving scorer filters every chunk with it)."""
    return torch.as_tensor(savgol_matrix(n, window_length, polyorder, deriv,
                                         delta).T, dtype=dtype, device=device)


def savgol_filter(x, window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0, dtype=None):
    """Savitzky-Golay filter along the last axis as one product with the
    operator in ``dtype`` (default: the input's), on the input's device."""
    dtype = dtype or x.dtype
    w = _operator_t(x.shape[-1], window_length, polyorder, deriv,
                    float(delta), dtype, x.device)
    with full_f32_matmul():
        return x.to(dtype) @ w


def snv_savgol(x, window_length: int = 5, polyorder: int = 2, deriv: int = 1,
               eps: float = 1e-8):
    """SNV then Savitzky-Golay, the reference's spectral preprocessing."""
    return savgol_filter(snv(x, eps=eps), window_length, polyorder, deriv)
