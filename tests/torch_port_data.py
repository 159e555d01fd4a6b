"""Seeded inputs shared by the ``test_torch_port_*`` parity tests.

The recipe is ``bench.py:make_data`` at a small size: C classes of smooth
spectra (class-specific sine plus offset, random amplitude, white noise),
and a scored set that mixes fresh draws from every class with spectra of
no class, so that accept matrices hold both decisions.
"""

import numpy as np

N_CAL, LENGTH, N_CLASSES, N_SCORE, K = 120, 60, 3, 500, 4


def class_spectra(rng, c, n, length):
    t = np.linspace(0, 1, length)
    base = np.sin(2 * np.pi * (3 + c) * t) + 0.3 * c
    amp = rng.normal(1.0, 0.08, size=(n, 1))
    return amp * base[None, :] + rng.normal(0, 0.02, size=(n, length))


def make_data(seed=0, n_cal=N_CAL, length=LENGTH, n_classes=N_CLASSES,
              n_score=N_SCORE):
    """(calibration stack (C, n_cal, L), scored spectra (n_score, L)), f64."""
    rng = np.random.default_rng(seed)
    cals = np.stack([class_spectra(rng, c, n_cal, length)
                     for c in range(n_classes)])
    per = n_score // (n_classes + 1)
    parts = [class_spectra(rng, c, per, length) for c in range(n_classes)]
    t = np.linspace(0, 1, length)
    parts.append(rng.normal(0, 0.05, size=(n_score - per * n_classes, length))
                 + np.sin(2 * np.pi * 3 * t)[None, :])
    return cals, np.concatenate(parts)
