"""Traffic kind ``screen``: a camera client screening frames through
``VAEScorer.score``, one frame after another (closed loop).

Set-up makes each screened class's weights and calibration spectra from
the seed, calibrates through the program (``fit_vaesimca`` for variant
'vaesimca', ``fit_thresholds`` for 'd2'), builds one scorer (classes
stacked with ``stack_bundles`` where the traffic screens every class) and
a pool of frames, and warms the scorer on two frames.  The window hands
the pool's frames to the scorer in a seed-drawn order until its time is
up; a frame's latency runs from the call to its decisions on the host.
The check compares every answer of the window with the reference's
answer for that frame.

Traffic keys: ``variant`` ('vaesimca' | 'd2'), ``classes`` ('target' |
'all'), ``pool_frames``, ``class_shares`` (class or 'background' ->
share of the frame's pixels).
"""

from __future__ import annotations

import time

import numpy as np

from ocm_bench import compare, data, reference

UNIT = "frame"


def setup(ctx: dict) -> dict:
    cfg, traffic, seed, device = (ctx["cfg"], ctx["traffic"], ctx["seed"],
                                  ctx["device"])
    mark = ctx["mark"]
    import torch
    from ocm_tpu_torch.models.bundle import (new_bundle, spectral_stats,
                                             stack_bundles)
    from ocm_tpu_torch.models.vae import ConvVAE1D
    from ocm_tpu_torch.models.vae_decision import fit_thresholds
    from ocm_tpu_torch.models.vaesimca import fit_vaesimca
    from ocm_tpu_torch.serving import VAEScorer
    mark("import_program")

    variant = traffic["variant"]
    classes = reference.screen_classes(cfg, traffic)
    model = ConvVAE1D(cfg["input_length"], cfg["latent_dim"],
                      conv_blocks=cfg["conv_blocks"],
                      n_filters=cfg["n_filters"],
                      kernel_size=cfg["kernel_size"], stride=cfg["stride"],
                      hidden_fc=cfg["hidden_fc"],
                      activation=cfg["activation"])
    weights = [data.vae_weights(cfg, seed, (data.WEIGHTS, c), device=device)
               for c in classes]
    x_cals = [data.calibration_set(cfg, seed, c, device) for c in classes]
    pool = data.frame_pool(cfg, traffic, seed, device)
    mark("data_and_model")

    bundles, fitted = [], []
    for sd, x_cal in zip(weights, x_cals):
        mean, std = spectral_stats(x_cal)
        bundle = new_bundle(sd, mean, std, cfg["latent_dim"])
        if variant == "vaesimca":
            v = cfg["vaesimca"]
            fitted.append(fit_vaesimca(model, bundle, x_cal,
                                       decision_type=v["decision_type"],
                                       t2lim=v["t2lim"], t2cl=v["t2cl"],
                                       qlim=v["qlim"], qcl=v["qcl"]))
        else:
            bundle = fit_thresholds(model, bundle, x_cal,
                                    loss_type=cfg["loss_type"],
                                    percentile=cfg["d2_percentile"])
        bundles.append(bundle)
    stacked = len(classes) > 1
    bundle = stack_bundles(bundles) if stacked else bundles[0]
    vs = None
    if variant == "vaesimca":
        vs = stack_bundles(fitted) if stacked else fitted[0]
        calib = {"t2_limit": vs.t2_limit, "q_limit": vs.q_limit}
    else:
        calib = {"threshold": bundle.threshold}
    calib = {k: np.atleast_1d(v.detach().cpu().numpy()) for k, v in
             calib.items()}
    scorer = VAEScorer(model, bundle, variant=variant,
                       loss_type=cfg["loss_type"],
                       chunk_size=cfg["chunk_size"], vaesimca_model=vs,
                       decision_type=cfg["vaesimca"]["decision_type"])
    mark("calibration")

    for frame in pool[:2]:
        scorer.score(frame, prefetch=cfg["prefetch"])
    if device != "cpu":
        torch.cuda.synchronize()
    mark("warm_up")
    return {"scorer": scorer, "pool": pool, "calib": calib,
            "classes": len(classes)}


def window(ctx: dict, state: dict, seconds: float) -> dict:
    cfg = ctx["cfg"]
    scorer, pool, prefetch = state["scorer"], state["pool"], cfg["prefetch"]
    order = data.frame_order(ctx["seed"], len(pool), 1 << 16)
    answers, latencies = [], []
    clock = time.perf_counter
    t0 = end = clock()
    while end - t0 < seconds:
        i = int(order[len(answers)])
        start = clock()
        out = scorer.score(pool[i], prefetch=prefetch)
        end = clock()
        latencies.append(end - start)
        answers.append((i, out))
    frames = len(answers)
    return {"t0": t0, "t_end": end, "answers": answers,
            "unit_times": latencies,
            "counts": {"frames": frames, "classes": state["classes"],
                       "spectra": frames * cfg["frame_spectra"]},
            "attempted": frames, "failed": 0}


def end_to_end(ctx: dict, record: dict) -> dict:
    span = record["t_end"] - record["t0"]
    return {"spectra_per_s": record["counts"]["spectra"] / span,
            "frame_p95_ms": 1e3 * float(np.percentile(record["unit_times"],
                                                      95))}


def release(state: dict) -> dict:
    """Free the program's state; keep what the check reads."""
    return {"pool": state["pool"], "calib": state["calib"]}


def check(ctx: dict, kept: dict, record: dict, tf32: bool = False) -> dict:
    """The comparison's numbers.  ``tf32`` puts the reference computed in
    TF32 (the control) in the program's place."""
    cfg, traffic = ctx["cfg"], ctx["traffic"]
    ref = reference.ScreenReference(cfg, traffic, ctx["seed"],
                                    ctx["device"])
    used = sorted({i for i, _ in record["answers"]})
    ref_frames = {i: ref.score(kept["pool"][i]) for i in used}
    prog_calib = kept["calib"]
    answers = record["answers"]
    if tf32:
        ctl = reference.ScreenReference(cfg, traffic, ctx["seed"],
                                        ctx["device"], tf32=True)
        answers = [(i, ctl.score(kept["pool"][i])) for i in used]
        prog_calib = ctl.calib
    limits = ctx["limits"]
    band = 2.0 * (limits["stat_gap"] + limits["calib_gap"])
    return compare.screen_numbers(traffic["variant"], answers, ref_frames,
                                  prog_calib, ref.calib,
                                  len(answers) if tf32 else
                                  record["attempted"], band)
