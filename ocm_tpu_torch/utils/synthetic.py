"""Synthetic stand-ins for the reference's proprietary datasets (port of
``ocm_tpu/utils/synthetic.py``, plain numpy, bit-equal to it for the same
seed).

The cheese FTIR .mat and SWIR nut cubes are not redistributable, so the
examples default to shape-faithful synthetic data: cheese-like (N~700,
L~500, 5 classes, data_cheese.py) and nut-like HSI cubes (842-2532 nm
SWIR axis, several objects per image, nut_data.py:11-13).  Pass real
paths to run on the actual datasets.
"""

from __future__ import annotations

import numpy as np

CHEESE_LENGTH = 501
NUT_WAVELENGTHS = 288
NUT_TYPES = ("almond", "cashew", "hazelnut", "peanut", "walnut")


def cheese_like(seed: int = 42, n_per_class: int = 140, length: int = CHEESE_LENGTH,
                n_classes: int = 5):
    """(x_train, y_train, x_test, y_test) shaped like IR_ML.mat."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, length)

    def cls_block(c, n):
        base = (np.sin(2 * np.pi * (2 + 0.7 * c) * t)
                + 0.5 * np.cos(2 * np.pi * (5 + c) * t) + 0.2 * c)
        amp = rng.normal(1.0, 0.08, (n, 1))
        shift = rng.normal(0.0, 0.03, (n, 1))
        return amp * base[None, :] + shift + rng.normal(0, 0.02, (n, length))

    xs, ys = [], []
    for c in range(n_classes):
        xs.append(cls_block(c, n_per_class))
        ys.append(np.full(n_per_class, c))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    perm = rng.permutation(len(y))
    x, y = x[perm], y[perm]
    n_tr = int(0.7 * len(y))
    return x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:]


def nut_cube(seed: int = 0, nut_idx: int = 0, height: int = 64,
             width: int = 64, length: int = NUT_WAVELENGTHS,
             n_objects: int = 6, radius_range=(3, 6)):
    """One synthetic SWIR cube with disk-shaped nut objects on a dark
    background (nut_data.py segmentation input shape).

    ``radius_range=(lo, hi)``: object radii are drawn from
    [lo, hi) pixels — scale with height/width for large cubes so the
    object-pixel fraction stays camera-realistic (the default keeps the
    historical 3-6 px disks and bit-identical outputs for old seeds).
    """
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, length)
    base = np.sin(2 * np.pi * (2 + 0.5 * nut_idx) * t) + 1.5 + 0.3 * nut_idx
    cube = rng.normal(0.02, 0.01, (height, width, length))
    yy, xx = np.mgrid[:height, :width]
    margin = max(8, int(radius_range[1]) + 2)
    for _ in range(n_objects):
        cy = rng.integers(margin, height - margin)
        cx = rng.integers(margin, width - margin)
        r = rng.integers(*radius_range)
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        amp = rng.normal(1.0, 0.05)
        cube[mask] = (amp * base[None, :]
                      + rng.normal(0, 0.02, (int(mask.sum()), length)))
    return cube


def nut_objects(seed: int = 42, n_objects: int = 8, pixels: int = 40,
                length: int = NUT_WAVELENGTHS):
    """class -> list of per-object spectra arrays (object_aware_splits
    input)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, length)
    data = {}
    for i, nut in enumerate(NUT_TYPES):
        base = np.sin(2 * np.pi * (2 + 0.5 * i) * t) + 1.5 + 0.3 * i
        objs = []
        for _ in range(n_objects):
            amp = rng.normal(1.0, 0.05, (pixels, 1))
            objs.append((amp * base[None, :]
                         + rng.normal(0, 0.02, (pixels, length)))
                        .astype(np.float32))
        data[nut] = objs
    return data
