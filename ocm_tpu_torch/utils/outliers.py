"""PCA score-space Mahalanobis outlier removal (port of
``ocm_tpu/utils/outliers.py``).

The reference removes pixel-level outliers before splitting with a
PCA(<=10)-score Mahalanobis distance thresholded at the 95th percentile
(``utils/data_utils.py:65-85``; the same logic with squared distances inlined
at ``simca_nuts.py:127-150``).  Hyperspectral nut images yield 10^4-10^6 pixel
spectra, so this runs on the card: one reduced SVD (or a covariance product
and a randomized top-k solve), one product and reductions, all in full f32
(no TF32).
"""

from __future__ import annotations

import torch

from ocm_tpu_torch._device import as_tensor
from ocm_tpu_torch.ops.linalg import (cov, full_f32_matmul, pca_fit,
                                      pca_topk_cov, pinv_psd)


def percentile_of(v, q: float):
    """``np.percentile(v, q)`` of a 1-D tensor, linearly interpolated at
    ``q / 100 * (n - 1)`` of the sorted values (numpy's and
    ``jnp.percentile``'s default; ``torch.quantile`` refuses inputs above
    2^24 elements)."""
    v_sorted = v.sort().values
    n = v_sorted.shape[0]
    idx = q / 100.0 * (n - 1)
    lo = min(max(int(idx // 1), 0), n - 1)
    hi = min(lo + 1, n - 1) if idx > lo else lo
    frac = idx - lo
    return v_sorted[lo] * (1.0 - frac) + v_sorted[hi] * frac


def mahalanobis_outlier_mask(x_proc, n_components: int = 10,
                             percentile: float = 95.0,
                             squared: bool = False, solver: str = "svd",
                             device=None, omega=None):
    """(keep_mask, distances, threshold) for rows of ``x_proc``.

    ``squared=False`` takes the sqrt like ``utils/data_utils.py:79``;
    ``squared=True`` matches the inlined variant of ``simca_nuts.py:138-144``
    (monotone in the distance, so the keep decision is identical).
    Keep rule is ``distance <= percentile(distances)``.

    ``solver='svd'`` takes the scores from the port's ``pca_fit`` (one
    reduced SVD of the centered pixels); ``solver='rsvd'`` from the
    full-f32 covariance and ``pca_topk_cov``'s randomized top-k subspace,
    whose (L, s) test matrix ``omega`` defaults to ``default_omega`` on
    the device (pass the JAX package's draw to replay it).  Signs and
    rotations within the subspace do not change a Mahalanobis distance.

    Numpy input goes to ``device`` (CUDA unless given) in its own dtype,
    float64 becoming float32 on CUDA (``_device.as_tensor``); a tensor
    stays where it is.  Returns tensors on that device.
    """
    if solver not in ("svd", "rsvd"):
        raise ValueError(f"unknown solver {solver!r}; expected 'svd' or"
                         " 'rsvd'")
    x = as_tensor(x_proc, device)
    with full_f32_matmul():
        if solver == "rsvd":
            xc = x - x.mean(0)
            c = (xc.T @ xc) / (x.shape[0] - 1.0)
            s_sub = min(n_components + 10, x.shape[1], x.shape[0] - 1)
            _, vecs = pca_topk_cov(c, s_sub, omega=omega)
            t = xc @ vecs[:, :n_components]
        else:
            t = pca_fit(x).scores[:, :n_components]
        cov_inv = pinv_psd(cov(t))
        d = t - t.mean(0)
        mahal = ((d @ cov_inv) * d).sum(-1)
    if not squared:
        mahal = torch.sqrt(mahal)
    threshold = percentile_of(mahal, percentile)
    return mahal <= threshold, mahal, threshold


def effective_n_components(n_samples: int, n_features: int,
                           cap: int = 10) -> int:
    """min(cap, L, n-1) guard of utils/data_utils.py:66."""
    return min(cap, n_features, max(1, n_samples - 1))
