"""Chip smoke run of the PyTorch/CUDA port (``ocm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path at the benchmark's full width -- a batched
3-class SIMCA fit (3 x 700 x 500, k = 10, randomized solver), then fused
multi-class T^2/Q scoring of 98,304 spectra and the accept decision --
and holds the hand-written CUDA scoring kernel against its plain PyTorch
twin.  Phases, each of which exits non-zero on failure:

1. device and numerics: card name and power limit, TF32 off;
2. build: the kernel library, compiled with nvcc for sm_90a at first use;
3. kernel vs plain twin on the card in f32: at the bench shapes, at a
   ragged single-class shape, and at two shapes that take the kernel's
   other paths (class groups, chunks of L, k > 32, L not a multiple of 4);
4. main path: launches counted, limits finite and positive, the card's f32
   fit against the port's own f64 CPU fit of the same data;
5. timings with CUDA events (median after warm-up) beside the kernel's
   bound.

Prints a JSON line with the kernel's record, the card's ``nvidia-smi``
name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ocm_tpu_torch.models.simca import fit_simca, predict_classes
from ocm_tpu_torch.ops import _build, kernels
from ocm_tpu_torch.ops.linalg import default_omega
from ocm_tpu_torch.stats.limits import reduced_distance, t2_limit

N_CAL, LENGTH, N_CLASSES, N_SCORE, K = 700, 500, 3, 98304, 10
SEED = 0
# (bytes/s, f32 FLOP/s outside the tensor cores): NVIDIA data sheets,
# dense, at the full power limit
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}


def make_data(seed=SEED, n_cal=N_CAL, length=LENGTH, n_classes=N_CLASSES,
              n_score=N_SCORE):
    """The benchmark's seeded workload (same recipe as bench.py's)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, length)
    cals = []
    for c in range(n_classes):
        base = np.sin(2 * np.pi * (3 + c) * t) + 0.3 * c
        amp = rng.normal(1.0, 0.08, size=(n_cal, 1))
        cals.append((amp * base[None, :]
                     + rng.normal(0, 0.02, size=(n_cal, length))))
    xs = rng.normal(0, 1, size=(n_score, length)) + np.sin(
        2 * np.pi * 3 * t)[None, :]
    return np.stack(cals), xs


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise SystemExit(f"chip_smoke: no peak rates on record for {name!r}")


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def median_ms(fn, warmup=2, reps=7):
    """Median CUDA-event time of ``fn()`` in ms, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_scores(x, means, comps, invcovs):
    """One PyTorch formulation of the same function, as the XLA path
    computes it: one product with the stacked [P_1^T .. P_C^T | m_1 .. m_C]
    plus reductions (the Q expansion included).  Timed as a yardstick
    only; the port never calls it."""
    c, k, length = comps.shape
    w = torch.cat([comps.reshape(c * k, length).T, means.T], dim=1)
    g = x @ w
    xp = g[:, :c * k].reshape(-1, c, k).permute(1, 0, 2)
    t = xp - torch.einsum("cl,ckl->ck", means, comps)[:, None, :]
    q = ((x * x).sum(-1)[None] - 2.0 * g[:, c * k:].T
         + (means * means).sum(-1)[:, None] - (t * t).sum(-1)).clamp_min(0.0)
    return torch.einsum("cnj,cjk,cnk->cn", t, invcovs, t), q


def compare_kernel(label, x, models, decision_type="alt"):
    """Kernel vs plain twin on the card; returns the max absolute error."""
    args = [a.contiguous() for a in (x, models.mean, models.components,
                                     models.invcovT)]
    t2, q = kernels.t2q_scores_multiclass(*args)
    torch.cuda.synchronize()
    t2_p, q_p = kernels.t2q_scores_multiclass_plain(*args)
    xc2 = ((args[0][None] - args[1][:, None]) ** 2).sum(-1)
    check(bool(torch.isfinite(t2).all() and torch.isfinite(q).all()),
          f"{label}: non-finite kernel output")
    t2_rel = ((t2 - t2_p).abs() / t2_p.abs()).max().item()
    q_rel = ((q - q_p).abs() / xc2).max().item()
    err = max((t2 - t2_p).abs().max().item(), (q - q_p).abs().max().item())
    line = {"phase": "kernel_vs_plain", "shape": label,
            "t2_max_rel": t2_rel, "q_max_rel_of_norm": q_rel,
            "max_abs_err": err}
    check(t2_rel <= 1e-4, f"{label}: T2 rel err {t2_rel} > 1e-4")
    check(q_rel <= 1e-4, f"{label}: Q err {q_rel} > 1e-4 of ||x - m||^2")
    if models.d_limit is not None:
        d_lim = models.d_limit[:, None]
        dred = reduced_distance(decision_type, t2, q, models.t2_res, models.q_res)
        dred_p = reduced_distance(decision_type, t2_p, q_p, models.t2_res,
                                  models.q_res)
        differ = (dred < d_lim) != (dred_p < d_lim)
        agree = 1.0 - differ.float().mean().item()
        near = ((dred_p - d_lim).abs() <= 1e-4 * d_lim.abs()) | ~differ
        line.update(accept_agreement=agree, accept_rate=(dred < d_lim).float().mean().item())
        check(agree >= 0.9999, f"{label}: accept agreement {agree} < 0.9999")
        check(bool(near.all()), f"{label}: a disagreement lies off the boundary")
    print(json.dumps(line), flush=True)
    return err


class _Scorer:
    """Means, loadings, inverse covariances and limits of random models
    (for the shape that no fitted model reaches)."""

    def __init__(self, c, k, length, gen, dev):
        self.mean = (5.0 + 0.1 * torch.randn(c, length, generator=gen)).to(dev)
        self.components = torch.linalg.qr(
            torch.randn(c, length, k, generator=gen))[0].mT.to(dev)
        a = torch.randn(c, k, k, generator=gen)
        self.invcovT = (a @ a.mT / k + torch.eye(k)).to(dev)
        self.d_limit = None


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    # 1. device and numerics
    card = card_line()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}", flush=True)
    print(json.dumps({"phase": "device", "device_name": name,
                      "device_count": torch.cuda.device_count(),
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                      "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "float32_matmul_precision":
                          torch.get_float32_matmul_precision()}), flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log = _build.library_path().with_suffix(".log")
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "library": _build.library_path().name}), flush=True)
    if log.exists():
        print(log.read_text().strip(), flush=True)

    cals, xs = make_data()
    cals32 = cals.astype(np.float32)
    xs32 = xs.astype(np.float32)
    x_dev = torch.as_tensor(xs32, device=dev)
    cals_dev = torch.as_tensor(cals32, device=dev)

    # 3. kernel vs plain twin: bench shapes, a ragged single class, a shape
    #    with three class groups and 32 chunks of L, and one with k > 32
    #    (two passes of loading rows) and L not a multiple of 4
    models = fit_simca(cals_dev, K, solver="rsvd")
    bench_err = compare_kernel("bench N=98304 L=500 C=3 k=10", x_dev, models)
    rc, _ = make_data(seed=1, n_cal=200, length=96, n_classes=1, n_score=1)
    small = fit_simca(torch.as_tensor(rc[:1], dtype=torch.float32, device=dev),
                      8, solver="rsvd")
    compare_kernel("ragged N=137 L=96 C=1 k=8",
                   torch.as_tensor(rc[0, :137], dtype=torch.float32, device=dev),
                   small)
    gen = torch.Generator().manual_seed(0)
    for n, length, c, k in ((1000, 2000, 5, 12), (300, 203, 2, 40)):
        compare_kernel(f"groups N={n} L={length} C={c} k={k}",
                       (torch.randn(n, length, generator=gen) + 5.0).to(dev),
                       _Scorer(c, k, length, gen, dev))

    # 4. the main path, as a user calls it, with the launch count read
    kernels.t2q_scores_multiclass.launches = 0
    models = fit_simca(cals32, K, solver="rsvd")
    accept, dred, t2, q = predict_classes(models, xs32)
    torch.cuda.synchronize()
    launches = kernels.t2q_scores_multiclass.launches
    check(launches >= 1, "the main path launched no scoring kernel")
    check(accept.shape == (N_CLASSES, N_SCORE), f"accept shape {accept.shape}")
    check(bool(torch.isfinite(dred).all()), "non-finite reduced distances")
    lims = {"t2_limit": models.t2_res.limit, "q_limit": models.q_res.limit,
            "d_limit": models.d_limit}
    for key, v in lims.items():
        check(bool(torch.isfinite(v).all() and (v > 0).all()),
              f"{key} not finite and > 0: {v.tolist()}")
    # the port's own f64 CPU fit of the same data, with the card's test
    # matrix, as the reference
    omega = default_omega(LENGTH, K + 10, torch.float32, dev)
    ref = fit_simca(cals, K, solver="rsvd", device="cpu",
                    omega=omega.double().cpu())
    acc_ref = predict_classes(ref, xs)[0]
    ref_lims = {"t2_limit": ref.t2_res.limit, "q_limit": ref.q_res.limit,
                "d_limit": ref.d_limit}
    rel = {key: ((lims[key].double().cpu() - ref_lims[key]).abs()
                 / ref_lims[key].abs()).max().item() for key in lims}
    agree = (accept.cpu() == acc_ref).float().mean().item()
    print(json.dumps({"phase": "main_path", "launches": launches,
                      "q_limit": models.q_res.limit.tolist(),
                      "t2_limit": models.t2_res.limit.tolist(),
                      "accept_rate": accept.float().mean(1).tolist(),
                      "limit_rel_err_vs_cpu_f64": rel,
                      "accept_agreement_vs_cpu_f64": agree}), flush=True)
    for key, r in rel.items():
        check(r <= 1e-3, f"{key} differs from the CPU f64 fit by {r}")
    check(agree >= 0.999, f"accept agreement vs CPU f64 {agree} < 0.999")

    # 5. timings, with the card's name and power limit beside them
    args = [a.contiguous() for a in (x_dev, models.mean, models.components,
                                     models.invcovT)]
    fit_ms = median_ms(lambda: fit_simca(cals_dev, K, solver="rsvd"),
                       warmup=1, reps=3)
    # the fit's T^2 limit alone (F quantile by bisection on the card)
    t2_limit_ms = median_ms(lambda: t2_limit(models.t2_train, K),
                            warmup=1, reps=3)
    predict_ms = median_ms(lambda: predict_classes(models, x_dev))
    kernel_ms = median_ms(lambda: kernels.t2q_scores_multiclass(*args),
                          warmup=3, reps=21)
    plain_ms = median_ms(lambda: kernels.t2q_scores_multiclass_plain(*args))
    library_ms = median_ms(lambda: library_scores(*args))
    bw, f32_rate = peaks(name)
    n, length, c, k = N_SCORE, LENGTH, N_CLASSES, K
    nbytes = 4 * (n * length + c * length + c * k * length + c * k * k
                  + 2 * c * n)
    flops = n * c * (length * (2 * k + 3) + 2 * k * k + 4 * k + 1)
    bytes_ms, flops_ms = 1e3 * nbytes / bw, 1e3 * flops / f32_rate
    bound_ms = max(bytes_ms, flops_ms)
    print(json.dumps({"phase": "timings", "card": card, "fit_ms": fit_ms,
                      "t2_limit_ms": t2_limit_ms,
                      "predict_ms": predict_ms, "kernel_ms": kernel_ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_bytes_ms": bytes_ms, "bound_flops_ms": flops_ms,
                      "kernel_share_of_bound": bound_ms / kernel_ms,
                      "build_s": build_s}), flush=True)

    record = {"name": "t2q_scores_multiclass", "route": "cuda",
              "source": "ocm_tpu_torch/csrc/t2q_scores.cu",
              "replaces": "ocm_tpu/ops/kernels.py:45", "launches": launches,
              "max_abs_err": bench_err, "ms": kernel_ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms,
              "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
              "library_ms": library_ms}
    check(all(math.isfinite(v) for v in (kernel_ms, plain_ms, library_ms)),
          "a timing is not finite")
    print(json.dumps({"kernels": [record]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
