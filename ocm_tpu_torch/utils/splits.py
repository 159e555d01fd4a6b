"""Object-aware dataset splitting (port of ``ocm_tpu/utils/splits.py``).

Re-design of ``utils/data_utils.py:12-168``: spectra belonging to the same
physical object (one nut in a hyperspectral image) never straddle the
cal/val/test boundary.  The pipeline per class:

1. stack per-object spectra, drop NaN/inf rows (:49-54);
2. SNV + SavGol(5,2,deriv=1) copy for outlier detection (:57-61), on the
   card (``ops.preprocess.snv_savgol``);
3. PCA(<=10)-score Mahalanobis outlier removal at the 95th percentile
   (:65-85), on the card (``utils.outliers``);
4. split at the OBJECT level 70/15/15 with sklearn-equivalent seeded
   shuffling (:104-121), in numpy in the reference's order —
   ``shuffle_split`` reproduces
   ``sklearn.model_selection.train_test_split(random_state=...)``
   permutation-for-permutation;
5. assemble the global test set with labels 0=target / 1=other (:137-154)
   and the concatenated other-class test set ``X_test_out`` (:162-166).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ocm_tpu_torch._device import resolve_device
from ocm_tpu_torch.ops.preprocess import snv_savgol
from ocm_tpu_torch.utils.outliers import (effective_n_components,
                                          mahalanobis_outlier_mask)


def shuffle_split(items: Sequence, test_size: float, random_state=None):
    """sklearn ``train_test_split(items, test_size=..., random_state=...)``:
    n_test = ceil(test_size*n); a seeded RandomState permutation; test =
    first n_test entries, train = the rest — identical element order."""
    items = list(items)
    n = len(items)
    n_test = int(math.ceil(test_size * n))
    n_train = n - n_test
    if n_train == 0 or n_test == 0:
        raise ValueError(
            f"test_size={test_size} leaves an empty split for {n} items")
    perm = np.random.RandomState(random_state).permutation(n)
    test = [items[i] for i in perm[:n_test]]
    train = [items[i] for i in perm[n_test:n_test + n_train]]
    return train, test


class ObjectSplits(NamedTuple):
    """Return bundle of ``object_aware_splits`` (utils/data_utils.py:23-31)."""

    splits: dict                 # class -> {'cal','val','test'} arrays
    x_test: np.ndarray           # global test set (all classes)
    y_test: np.ndarray           # 0 = target, 1 = other
    x_cal: np.ndarray            # target calibration
    x_val: np.ndarray            # target validation
    x_test_in: np.ndarray        # target test
    x_test_out: np.ndarray       # concatenated other-class test


def object_aware_splits(data: Mapping[str, Sequence], class_names,
                        target_class: str, n_wavelengths: int,
                        cal_frac: float = 0.7, val_frac: float = 0.15,
                        test_frac: float = 0.15, random_state: int = 42,
                        outlier_percentile: float = 95.0,
                        use_pca: bool = True,
                        verbose: bool = True, device=None) -> ObjectSplits:
    """Object-aware cal/val/test split (utils/data_utils.py:12-168).

    ``data`` maps class name -> list of objects, each either an array of
    spectra (n_pixels, L) or a dict with a 'spectral_data' entry.  The
    outlier step's SNV + SavGol and Mahalanobis mask run in f32 on
    ``device`` (CUDA unless given); everything else is numpy.
    """
    if abs(cal_frac + val_frac + test_frac - 1.0) >= 1e-6:
        raise ValueError("cal/val/test fractions must sum to 1")
    device = resolve_device(device) if use_pca else None

    def empty():
        return np.empty((0, n_wavelengths), dtype=np.float32)

    splits: dict = {}
    for cls in class_names:
        obj_spectra = []
        for obj in data[cls]:
            arr = obj["spectral_data"] if isinstance(obj, Mapping) else obj
            obj_spectra.append(np.asarray(arr, dtype=np.float32))
        if not obj_spectra:
            splits[cls] = {"cal": empty(), "val": empty(), "test": empty()}
            continue

        lengths = [s.shape[0] for s in obj_spectra]
        x = np.vstack(obj_spectra)
        obj_ids = np.concatenate(
            [np.full(l, i, dtype=int) for i, l in enumerate(lengths)])

        bad = np.isnan(x).any(axis=1) | np.isinf(x).any(axis=1)
        if bad.any():
            if verbose:
                print(f"  {cls}: removed {int(bad.sum())} NaN/inf samples")
            x, obj_ids = x[~bad], obj_ids[~bad]

        if use_pca and x.shape[0] > 3:
            n_comp = effective_n_components(x.shape[0], x.shape[1])
            if x.shape[0] > n_comp:
                x_proc = snv_savgol(torch.as_tensor(x, device=device),
                                    5, 2, 1)
                keep, _, thr = mahalanobis_outlier_mask(
                    x_proc, n_components=n_comp,
                    percentile=outlier_percentile)
                keep = keep.cpu().numpy()
                if verbose and (~keep).any():
                    print(f"  {cls}: removed {int((~keep).sum())} outliers "
                          f"(threshold {float(thr):.3f})")
                x, obj_ids = x[keep], obj_ids[keep]

        objects = {int(i): x[obj_ids == i] for i in np.unique(obj_ids)
                   if np.sum(obj_ids == i) > 0}
        if not objects:
            splits[cls] = {"cal": empty(), "val": empty(), "test": empty()}
            continue

        obj_keys = list(objects.keys())
        if len(obj_keys) >= 3:
            cal_objs, temp = shuffle_split(obj_keys, 1.0 - cal_frac,
                                           random_state)
            rel = (test_frac / (val_frac + test_frac)
                   if (val_frac + test_frac) > 0 else 0.5)
            val_objs, test_objs = shuffle_split(temp, rel, random_state)
        elif len(obj_keys) == 2:
            cal_objs, val_objs, test_objs = [obj_keys[0]], [], [obj_keys[1]]
        else:
            cal_objs, val_objs, test_objs = [obj_keys[0]], [], []

        def gather(keys):
            if not keys:
                return empty()
            return np.vstack([objects[k] for k in keys])

        splits[cls] = {"cal": gather(cal_objs), "val": gather(val_objs),
                       "test": gather(test_objs)}
        if verbose:
            s = splits[cls]
            print(f"  {cls}: objects={len(objects)} -> cal={s['cal'].shape}, "
                  f"val={s['val'].shape}, test={s['test'].shape}")

    xts, yts = [], []
    for cls in class_names:
        t = splits[cls]["test"]
        if t.shape[0] == 0:
            continue
        xts.append(t)
        yts.append(np.full(t.shape[0], 0 if cls == target_class else 1,
                           dtype=int))
    x_test = np.vstack(xts) if xts else empty()
    y_test = np.concatenate(yts) if yts else np.array([], dtype=int)

    others = [splits[c]["test"] for c in class_names
              if c != target_class and splits[c]["test"].shape[0] > 0]
    x_test_out = np.vstack(others) if others else empty()

    return ObjectSplits(splits, x_test, y_test, splits[target_class]["cal"],
                        splits[target_class]["val"],
                        splits[target_class]["test"], x_test_out)
