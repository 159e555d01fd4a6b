"""The numbers that decide ``correct``: the program's outputs against the
reference's, each a gap that a limit in ``cells/<workload>.json`` bounds.

Screens (one number each over every answer the window produced):

- ``stat_gap``: the widest gap of a statistic (T^2 and Q of VAE-SIMCA, the
  latent D^2), |program - reference| / max(|reference|, the median
  |reference| of that statistic in that frame and class);
- ``calib_gap``: the widest relative gap of the limits fitted in set-up
  (VAE-SIMCA's T^2 and Q limits, the D^2 threshold);
- ``decision_flips``: the decisions (spectrum x class) that differ from the
  reference's although the reference's distance lies outside the band in
  which the two limits above allow a flip: |distance / limit - 1| >
  2 (stat_gap limit + calib_gap limit), with VAE-SIMCA's reduced distance
  against sqrt(2) and D^2 against its threshold.  An exact comparison.

A missing answer or a shape that differs reads ``inf``.
"""

from __future__ import annotations

import math

import numpy as np

STATS = {"vaesimca": ("t2", "q"), "d2": ("d2",)}


def _rel_gap(p, r, axis_scale=None) -> float:
    p = np.asarray(p, np.float64)
    r = np.asarray(r, np.float64)
    if p.shape != r.shape:
        return math.inf
    if p.size == 0:
        return 0.0
    scale = np.abs(r)
    if axis_scale is not None:
        scale = np.maximum(scale, axis_scale)
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.abs(p - r) / scale
    gap = np.where(np.abs(p - r) == 0, 0.0, gap)
    return float(np.nanmax(np.where(np.isnan(gap), np.inf, gap)))


def screen_numbers(variant: str, answers, ref_frames: dict, prog_calib: dict,
                   ref_calib: dict, expected: int, band: float) -> dict:
    """``answers``: (pool index, output dict) of every frame answered in
    the window; ``ref_frames``: pool index -> the reference's output dict
    (with ``margin``, its distance / limit - 1); ``band``: the half-width
    of the boundary band of ``decision_flips``."""
    stat_gap, flips = 0.0, 0
    if len(answers) != expected:
        stat_gap = math.inf
    for pool, out in answers:
        ref = ref_frames[pool]
        for key in STATS[variant]:
            if key not in out:
                stat_gap = math.inf
                continue
            r = np.asarray(ref[key], np.float64)
            med = np.median(np.abs(r), axis=0) if r.size else 0.0
            stat_gap = max(stat_gap, _rel_gap(out[key], r, med))
        p_acc = np.asarray(out.get("accept", ()), bool)
        r_acc = np.asarray(ref["accept"], bool)
        if p_acc.shape != r_acc.shape:
            stat_gap, flips = math.inf, flips + r_acc.size
        else:
            outside = np.abs(ref["margin"]) > band
            flips += int(((p_acc != r_acc) & outside).sum())
    calib_gap = max((_rel_gap(np.ravel(prog_calib[k]), np.ravel(ref_calib[k]))
                     for k in ref_calib), default=0.0)
    return {"stat_gap": stat_gap, "calib_gap": calib_gap,
            "decision_flips": flips}
