"""Chip smoke run of the PyTorch/CUDA port (``ocm_tpu_torch``) on one GPU.

    python3 chip_smoke.py                   # every phase below
    python3 chip_smoke.py --kernel-times    # kernel timings only
    python3 chip_smoke.py --bn-eval         # the build and phase 22 only

``--kernel-times`` times the kernels of the package beside the script;
a copy of the script placed in an unpacked older tree times that tree's,
so two versions are compared in turns within one chip call.

Drives the port's eight paths at full width and holds every hand-written
CUDA kernel against its plain PyTorch twin:

- SIMCA (first slice): a batched 3-class fit (3 x 700 x 500, k = 10,
  randomized solver), fused multi-class T^2/Q scoring of 98,304 spectra
  (kernel K1) and the accept decision;
- the VAE (second slice): ``train_vae`` of the entry model
  (``ConvVAE1D(501, 16)``, 3 conv blocks, 32 filters) on 640 spectra for
  20 epochs at batch 64 (``bench_all.py``'s training workload), through
  kernels K2/K3 (BatchNorm + activation, forward/backward), K4
  (reparameterize + KL) and K6's backward (its VJP);
- the VAE decisions (third slice): ``bench_all.py``'s VAE-SIMCA workload
  (512 calibration spectra, 3 epochs at batch 64, cosine loss), the
  thresholds deterministic and with the reference's sampled forward
  (kernel K5, noise drawn in the kernel), ``fit_vaesimca``, and a resident
  ``VAEScorer`` screening 65,536 spectra in chunks of 16,384 with every
  decision variant, single- and 3-class;
- SIMCA serving (fourth slice): ``bench.py``'s 3-class models screening
  98,304 spectra through a resident ``SIMCAScorer`` in chunks of 65,536
  at every storage width (f32, bf16 residuals through K1's bf16
  instantiation, int8 residuals through the exact int8 product K8, raw
  uint16 counts preprocessed on the card), the streaming moments fit, the
  bf16 ``VAEScorer`` twin, and the int8 probe (K7 and K8 at its headline
  shapes);
- CV-SIMCA and the masked fits (eighth slice): ``bench_all.py``'s CV
  workload (600 target and 300 other spectra x 500 channels, LVs 2-12, 5
  folds) swept with the randomized and the dense solver (covariance and
  Gram sides), every class at once, and through the grid search of
  ``examples/cv_simca.py`` whose refit predicts through K1;
  ``fit_classes`` of classes of 700, 520 and 340 spectra (the masked
  fit) and the ``SIMCA`` estimator scoring 98,304 spectra through K1; the
  four model files saved and loaded on the card;
- the data layer (ninth slice): ``examples/hsi_pipeline.py --cube-scale``
  (seven 512 x 512 x 288 uint16 camera cubes, 1,835,008 pixel spectra)
  segmented by the native C++ core, fitted at the object level and
  screened in the four serving modes (the int8 chunks prepared by the
  native fused center + quantize pass), ``examples/simca_nuts.py``'s
  object-aware splits (outlier removal on the card) and ``SIMCA``,
  ``examples/cheese_eda_plsda.py``'s PLS-DA, and a training run resumed
  from a ``TrainCheckpointer``;
- HPO and sweeps (tenth slice): ``bench_all.py``'s 8-config batched sweep
  of the entry model (320 spectra, 10 epochs at batch 64) as one stacked
  module (``models/stacked.py``: one K2/K3 launch a BatchNorm layer and
  one K4/K6 launch a step for every config) against the same 8 configs
  run one by one, ``examples/hpo_nuts.py``'s ASHA, TPE and BOHB searches
  at their defaults, ``examples/multiclass_vae_screen.py``'s class
  trainer and stacked screen, and ``examples/sweep_vae.py``'s artifact
  runner and its resume;
- the front doors (eleventh slice): float64 input on the card (fault F1:
  ``cheese_like()``'s float64 arrays, not cast, computed in float32), the
  CLI's commands in-process through ``ocm_tpu_torch.cli.main`` at its own
  full width (``--synthetic cheese``: 5 classes x 140 spectra x 501
  channels; the entry model ``ConvVAE1D(501, 16)`` for its default 100
  epochs), ``python -m ocm_tpu_torch info`` in a subprocess, the
  reference ``.pth`` export read back by ``VAEScorer.from_torch_checkpoint``,
  and the HTTP server.  Two parts stay out, because the card's machine has
  neither scikit-learn nor h5py: the sklearn estimators
  (``sklearn_api.py``, which call the same ``fit_simca``, ``fit_classes``,
  ``predict_classes``, ``train_vae`` and ``fit_vaesimca`` as this phase)
  and ``ingest`` / ``.h5`` input; the CPU tests hold them against
  ``ocm_tpu``;
- the multi-card paths (twelfth slice, ``ocm_tpu_torch/parallel``): the
  sharded SIMCA fit and screen (``examples/distributed_scoring.py``'s
  flow), streaming ingest and CV sweeps, data-parallel VAE training, the
  config- and class-sharded sweeps and ``mesh=`` on the scorers and ASHA,
  on a one-rank NCCL group and on two gloo ranks sharing the card.

Phases, each of which exits non-zero on failure:

1. device and numerics: card name and power limit, TF32 off, cuDNN's
   deterministic mode (selected when the package loads);
2. build: the kernel library (one nvcc per source, in parallel, sm_90a)
   and the host C++ core (g++),
   every kernel's registers, shared memory and spills, and its SASS's
   tensor-core (IMMA/IGMMA/HMMA/HGMMA) and dp4a (IDP) instructions: K8's
   tensor-core kernel must have the first and none of the second;
3. K1 vs its plain twin at the bench shapes and four other shapes (its
   resident and staged plans);
4. SIMCA main path: launches counted, limits finite and positive, the
   card's f32 fit against the port's own f64 CPU fit of the same data;
5. SIMCA timings with CUDA events (median after warm-up);
6. K2/K3 vs their twins at the six BatchNorm shapes of the train step
   (plus GELU and no activation), with K2's cluster size at each; K4 and
   K6's backward kernel vs their twins at (64, 16), (300, 5), (1, 1),
   (7, 33), (1,000, 64) and (3, 129) (and mu one float off alignment),
   and K6's gradients against autograd through the plain twin, with dz
   non-contiguous and dkl the stride-0 expand of ``kl.mean()``'s
   gradient; K4, K6's backward and K5 launched straight after the Linear
   that writes their input (they are programmatic dependents, which must
   wait for its writes);
7. VAE main path: launches counted (exactly 1200 K2, 1200 K3, 220 K4,
   200 K6 backward),
   finite and falling losses, one train step on the card in f32 against
   the port's CPU f64, and the entry model's forward and cosine loss;
8. VAE timings: one train step, the 20-epoch run, and each kernel beside
   its bound, its twin and the nearest PyTorch call (K2 and K3 over inputs
   that rotate past the L2, and L2-warm; K4 and K6's backward beside the
   launch floor, the empty kernel's device time, and each after the
   Linear that writes its input);
9. K5 vs its plain twin at (512, 16), (64, 16), (65,536, 16), (300, 5),
   (7, 33) and (3, 129): the kernel's own noise (bit-equal), z and KL,
   determinism and keying, and the noise's moments, Kolmogorov-Smirnov
   distance and neighbour correlations;
10. the decision path as a user calls it (numpy in): train, calibrate
   (exactly 1 K5 launch for the sampled calibration, none otherwise),
   ``fit_vaesimca``, the six screens (no K5; exactly ``K9_PER_CHUNK``
   K9 launches a chunk, 3 to 9), the 3-class stacked screen
   equal to 3 single-class ones, and the entry's sampled eval forward
   (1 K5 launch);
11. the card (f32) against the port's CPU f64 on the same trained bundle:
   thresholds, limits, and a 4,096-spectrum screen per variant;
12. decision timings: each screen, the calibration fits, a torch.profiler
   breakdown of one ``vaesimca`` chunk, the cost of cuDNN's deterministic
   mode, where a chunk of pinned 'f' spends its time, and K5 at (512, 16)
   and (65,536, 16) beside its bound, its twin, ``torch.randn`` then K4,
   and the launch floor;
13. K7 and K8 against their twins by integer equality (the probe's shapes
   and tiles, the scoring shape, ragged shapes), bf16 K1 at the serving
   shape and an odd L;
14. the serving path as a user calls it (numpy in, numpy out): the four
   modes' screens with exact launch counts (2 K1 for f32 and raw, 2 bf16
   K1, 2 K8 and no K1 for int8), the probe's scan (3 K7, 3 K8), the
   single-class scorer, agreement between the modes, prepared and
   sequential screens bit-equal, the streaming fit against
   ``fit_classes``, and the bf16 VAE twin against its f32 screens;
15. the card's f32 and int8 screens against the port's CPU f64;
16. serving timings: each mode's screen, its host prep + H2D against its
   device decision + fetch, the streaming ingest and fit, and K7, K8 and
   bf16 K1 beside their bounds, twins and library calls;
17. the CV slice as a user calls it (numpy in): the three sweeps, the
   multi-class sweep, the grid (its best estimator's predict: exactly 1
   K1 launch), the unequal-class fits (rsvd and eigh, each then 1 K1
   launch for 98,304 spectra) and ``SIMCA`` (1 K1 launch at one k, 3 at
   k 8, 10, 12); every limit finite and positive; the masked fit of three
   equal classes against ``fit_simca``; masked rsvd against eigh accepts
   and the cov side against the Gram side predictions (99.9 %); the
   card's f32 sweep cells against the port's CPU f64 (limits 1e-3, spec
   and sens within 2 samples, predictions 99.9 %); the four model kinds
   saved and reloaded on the card (scores bit-equal, a statistic refits
   to equal limits); the sweeps', grid's and masked fits' times with
   each sweep's split between decomposition, limit engines and the rest;
18. the data layer as a user calls it: the nut pipeline (native
   segmentation equal to the scipy route, the object-level fit, every
   pixel screened in the four modes with exact launches, 28 a pass: K1
   raw and f32, bf16 K1, K8 and no K1 for int8; bf16 and int8 accepts
   >= 99.5 % and raw >= 99.9 % of f32's; the int8 scorer's chunk
   bit-equal to the numpy twin's prep; K1, bf16 K1 and K8 against their
   twins at L 288), its HDF5 store round trip left out (no h5py on the
   card's machine); the nuts ``SIMCA`` (exactly 1 K1, held against its
   twin) and the outlier masks on the card against the CPU in f64 (keep
   masks >= 99.9 % equal, the same surviving objects); the cheese PLS-DA
   on the card against the CPU in f64 (the same best k, CV F1 within
   0.01, test predictions >= 99 %); a 2 + 2 epoch run resumed from a
   checkpoint against 4 uninterrupted epochs (1e-5; exact K2/K3/K4/K6
   launches of 8 epochs); and the data layer's timings;
19. HPO and sweeps as a user calls them: K2/K3 against their twins at
   the 8-config stacked shapes (64 x 256-1,024 x 126-504, the single
   model's cluster sizes) and K4 and K6's backward at (512, 16) with the
   per-config dkl autograd hands over (one launch); the 8-config stacked
   run with exact launches (6/6/1/1 a step, 1 K4 a validation), and again
   at 1 and 3 configs (the same counts); every config against its
   sequential ``train_vae`` (train losses 1e-5, val 2e-3, the same best
   epoch, diverged configs diverged at the same epochs); one stacked step
   on the card against the CPU in f64 (loss 1e-4, gradients 1e-3 of
   norm); ASHA (its rungs and epochs equal to its rule's), TPE and BOHB,
   each with exact K2/K3 launches from its returned schedule, a finite
   best value, then ``fit_thresholds`` and ``decide_f``; the 5-class
   trainer (exact launches) and its stacked screen equal to the single
   ones; the sweep runner and its resume (no launch); and the timings:
   stacked and single steps (with a grouped-convolution yardstick), their
   profiles, configs/s stacked and sequential, and each search's time;
20. the front doors as a user drives them: F1 (``SIMCA``, ``fit_classes``
   + ``predict_classes``, ``train_vae``, ``train_vae_classes`` and a
   2-trial ASHA on float64 numpy: float32 results with exact K1 and
   K2/K3/K4/K6 launches; a float64 CUDA tensor refused with ValueError);
   ``simca``, ``simca --all-classes`` (the masked fit), ``cv --refit``,
   ``stream-update`` twice then ``stream-fit``, and ``plsda``, each also
   run with ``--platform cpu`` (the port's CPU f64): limits within 1e-3,
   sensitivity and specificity within 2 samples, accepts >= 99.9 %; every
   SIMCA run dir screened in f32, bf16 and int8 (exactly 1 K1, 1 bf16 K1,
   1 K8 and no K1 a chunk of 8,192; bf16 and int8 accepts >= 99.5 % of
   f32's and dred within 3e-2 of its max, phase 16's contract), and K1,
   bf16 K1 and K8 against their twins at each screen's own operands
   (C 1 and C 5 at L 501, the path's decisions held against the twin's);
   ``train-vae`` and ``train-vae
   --all-classes`` at their defaults with exact launches from the class
   split sizes, finite and falling losses, every ``--variant`` and bf16
   screen (no kernel of the counted ones, no K5; K9's launches are phase
   22's), ``hpo --algo asha`` at its defaults (exact
   K2/K3/K4/K6 launches from its rungs and trials),
   ``export-torch`` and the ``.pth``'s screen bit-equal to the run dir's;
   the server over the stacked SIMCA run dir (warmup, a 65,536-spectrum
   npz request: exactly 8 K1 and bit-equal to ``score``, JSON, 8
   concurrent posts, a 429 at ``max_queue=1``, ``/reload`` to the VAE
   run dir), and the commands' and requests' times;
21. the sharded paths: pass (a), this process on a one-rank NCCL group
   (the fit, ``predict_sharded``, one DP step, the 8-config sweep), and
   pass (b), two spawned gloo ranks sharing ``cuda:0`` with CUDA tensors
   (every workload: the rsvd and eigh fits of bench class 0,
   ``predict_sharded`` of 98,304 spectra, phase 16's 7 ingest batches,
   the three sharded CV sweeps, one DP step and ``train_vae_dp`` of the
   entry model, the 8-config sweep, the 5-class trainer, the four screen
   widths at 98,304 and ASHA), pass (b) running beside pass (a) and the
   local paths; every rank held to the local path on the card (fit limits
   1e-4 and accepts 99.9 %; scores exact, dred 1e-5; moments 1e-5; CV 0.5
   pp and the same best LV; the DP step 1e-5 / 1e-4 of norm; sweeps at
   phase 19's contract; screens' accepts equal, statistics 1e-6), exact
   launches on every rank, (a) against (b); a rank that fails, dies or
   hangs fails the run;
22. the eval-mode conv epilogue K9 (``bn_act_eval_fused``) at the nuts
   screens' three activations (16,384 spectra of 32 x 288, 64 x 144 and
   128 x 72) and the entry model's five at 16,384 spectra (L 501, 251,
   126, 252, 504): the eager chain's bits with ELU and none, within 2
   ulp with GELU; at the nuts activations its device ms in
   place beside its byte bound and the chain's ms, one call with its
   wrapper; then nuts-width ``vaesimca`` and ``d2`` screens of 32,768
   spectra at chunk 16,384 with exactly 9 and 3 K9 launches a chunk, all
   counted fused, and answers bit-equal to the same screens with the
   kernel turned away.

Prints a JSON line with every kernel's record, the card's ``nvidia-smi``
name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from ocm_tpu_torch.models import bundle as vae_bundle
from ocm_tpu_torch.models import cv, plsda, stacked, streaming
from ocm_tpu_torch.models import trainer as vae_trainer
from ocm_tpu_torch.models import vae_decision, vaesimca
from ocm_tpu_torch.models.simca import (SIMCA, SIMCAModel, fit_classes,
                                        fit_simca, fit_simca_masked,
                                        load_simca_model, predict_classes,
                                        save_simca_model, stack_models)
from ocm_tpu_torch.models.vae import (BatchNormAct, ConvVAE1D, beta_vae_loss,
                                      recon_loss)
from ocm_tpu_torch.ops import _build, bn, kernels, linalg
from ocm_tpu_torch.ops.linalg import default_omega
from ocm_tpu_torch.ops.preprocess import snv_savgol
from ocm_tpu_torch.probes import int8 as int8_probe
from ocm_tpu_torch.serving import SIMCAScorer, VAEScorer
from ocm_tpu_torch.stats import metrics
from ocm_tpu_torch.stats.limits import LimitResult, reduced_distance, t2_limit
from ocm_tpu_torch.utils import checkpoint
from ocm_tpu_torch.utils import io as data_io
from ocm_tpu_torch.utils import (native, outliers, profiling, splits,
                                 sweep, synthetic, tpe)

N_CAL, LENGTH, N_CLASSES, N_SCORE, K = 700, 500, 3, 98304, 10
SEED = 0
# the VAE: __graft_entry__.entry()'s model, bench_all.py's training workload
VAE_KW = dict(input_length=501, latent_dim=16, conv_blocks=3, n_filters=32,
              kernel_size=9, stride=2, hidden_fc=256, activation="elu")
VAE_N, VAE_BATCH, VAE_EPOCHS = 640, 64, 20
# K4 and K6's backward against their twins at these (N, k) (phase 6)
REPARAM_SHAPES = [(64, 16), (300, 5), (1, 1), (7, 33), (1000, 64), (3, 129)]
# K5 against its twin at these (phase 9): the calibration's, the sampled
# entry forward's and the screen chunk's latent shapes, then odd k (pairs
# straddle rows), odd k above 32 and past 128
SAMPLE_SHAPES = [(512, 16), (64, 16), (65536, 16), (300, 5), (7, 33),
                 (3, 129)]
# the (B, C, L) of each BatchNorm of the entry model in one train step
TRAIN_BN_SHAPES = [(64, 32, 501), (64, 64, 251), (64, 128, 126),
                   (64, 64, 252), (64, 32, 504), (64, 32, 504)]
BN_EPS = 1e-5
# K9 at the nuts screens' conv activations: a chunk of 16,384 spectra of
# 32 x 288, 64 x 144 and 128 x 72 (ConvVAE1D(288, 16, hidden_fc=128),
# ocm_bench/configs/nuts_swir.json), and its f32 operations an element
# (the bias add, the subtraction, the multiply, the shift, ELU's expm1)
NUTS_KW = dict(input_length=288, latent_dim=16, conv_blocks=3, n_filters=32,
               kernel_size=9, stride=2, hidden_fc=128, activation="elu")
EVAL_CHUNK = 16384
EVAL_SHAPES = ((EVAL_CHUNK, 32, 288), (EVAL_CHUNK, 64, 144),
               (EVAL_CHUNK, 128, 72))
K9_OPS = 5
# K9's launches in a chunk of each decision variant of VAE_KW (three conv
# blocks each way): d2 encodes; d2_q, f and full encode and decode;
# vaesimca encodes, decodes and encodes the reconstruction
K9_PER_CHUNK = {"d2": 3, "d2_q": 6, "f": 6, "f_pinned": 6, "full": 6,
                "vaesimca": 9}
# f32 operations per element (the TPU kernels' own cost estimates,
# ocm_tpu/ops/bn.py:140,162) and per latent entry of K4 and of K6's
# backward (dmu: a multiply-add; dlv: two exps, a halving, five multiplies
# and adds, a subtraction and a difference)
K2_OPS, K3_OPS, K4_OPS, K6_OPS = 10, 16, 8, 12
# K5's operations per element pair, each counted at the f32 rate: ten
# Philox rounds of 2 mulhi, 2 mullo, 4 xor, 2 key adds (100); per element
# Box-Muller's shifts, conversions, scalings, log, sqrt and cos (12) and
# z's and the KL's exps, multiplies and adds (7)
K5_OPS_PER_PAIR = 100 + 2 * (12 + 7)
# the decision slice: bench_all.py:229-281's VAE-SIMCA workload
DEC_N_CAL, DEC_N_TEST, DEC_CHUNK, DEC_EPOCHS = 512, 65536, 16384, 3
DEC_N_MULTI, DEC_N_CPU = 16384, 4096
VARIANTS = (("d2", {}), ("d2_q", {}), ("f", {}), ("f_pinned",
            {"pin_f_stats": True}), ("full", {}), ("vaesimca", {}))
# the serving slice: bench.py's models screening 3 x 24,576 fresh class
# draws and 24,576 off-class spectra in chunks of 65,536
# (examples/hsi_pipeline.py's default); calibration batches of 300 for the
# streaming fit; the int8 probe's tiles
SRV_PER_CLASS, SRV_CHUNK, SRV_N_CPU, SRV_BATCH = 24576, 65536, 4096, 300
PROBE_TILES = (512, 1024, 2048)
SRV_MODES = ("f32", "bf16", "int8", "raw-u16")
# (bytes/s, f32 FLOP/s outside the tensor cores, int8 tensor-core OP/s):
# NVIDIA data sheets, dense (the int8 sheets' sparse figures halved), at
# the full power limit
# the H100's and H200's L2 cache
L2_BYTES = 50e6
PEAKS = {"H100 PCIe": (2.0e12, 51e12, 1513e12),
         "H100 NVL": (3.9e12, 60e12, 1671e12),
         "H200": (4.8e12, 67e12, 1979e12), "H100": (3.35e12, 67e12, 1979e12)}


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


def device_ms(fn, reps=50):
    """Device time of one ``fn()`` in ms.  The ``reps`` calls are queued
    behind a GPU sleep that outlasts their host-side enqueue, so the events
    time the kernels back to back, not the Python wrapper around them (a
    single call of a small kernel is otherwise host time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2e6 * (2 * host_ms + 1)))   # >= that many ms at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def k1_work(n, length, c, k, x_bytes):
    """(bytes, f32 operations) K1 needs for x (n, length) of ``x_bytes``
    an element against c models of k loadings: x, means, loadings and
    invcov read once, t2 and q written once; the centering, scores,
    ||xc||^2, T^2 and Q of every spectrum and class."""
    nbytes = x_bytes * n * length + 4 * (c * length + c * k * length
                                         + c * k * k + 2 * c * n)
    return nbytes, n * c * (length * (2 * k + 3) + 2 * k * k + 4 * k + 1)


def compare_kernel(label, x, models, decision_type="alt", path_accept=None):
    """Kernel vs plain twin on the card; returns the max absolute error.
    ``path_accept`` (C, N) bool, the decisions a path made on the same x
    and models, is held against the plain twin's decisions too."""
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
    (n, length), (c, k, _) = args[0].shape, args[2].shape
    plan = kernels.k1_plan(n, length, c, k, args[0].element_size(),
                           *_build.device_limits(args[0].device.index))
    line = {"phase": "kernel_vs_plain", "shape": label,
            "plan": plan._asdict(), "t2_max_rel": t2_rel,
            "q_max_rel_of_norm": q_rel, "max_abs_err": err}
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
        if path_accept is not None:
            off = path_accept != (dred_p < d_lim)
            path_agree = 1.0 - off.float().mean().item()
            line.update(path_accept_agreement=path_agree)
            check(path_agree >= 0.9999,
                  f"{label}: path vs plain accept agreement {path_agree}")
            check(bool((((dred_p - d_lim).abs() <= 1e-4 * d_lim.abs())
                        | ~off).all()),
                  f"{label}: a path decision differs off the boundary")
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


def resource_report(logs):
    """One line per kernel from ptxas's -v report: registers, spills,
    shared memory."""
    lines = []
    for source, text in logs.items():
        name = None
        for raw in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", raw)
            if m:
                name, spill, regs, smem = m.group(1), "?", "?", "0"
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          raw)
            if m and name:
                spill = f"{m.group(1)}/{m.group(2)}"
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", raw)
            if m and name:
                regs, smem = m.group(1), m.group(2) or "0"
                lines.append(f"ptxas {source}: {name} registers={regs} "
                             f"spill_stores/loads={spill} smem={smem}")
                name = None
    return lines


# kernels whose SASS must hold tensor-core instructions and no dp4a
TENSOR_CORE_KERNELS = {"int8.cu": "gemm_s8_mma_kernel"}


def sass_report():
    """Phase 2, SASS: per kernel of every object, its tensor-core integer
    and float instructions (IMMA, IGMMA, HMMA, HGMMA) and its dp4a (IDP),
    from ``cuobjdump -sass``.  Fails if a kernel of TENSOR_CORE_KERNELS has
    no tensor-core instruction or any IDP."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    rows = []
    for source in _build.SOURCES:
        text = subprocess.run([tool, "-sass", str(_build.object_path(source))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        for chunk in text.split("Function : ")[1:]:
            name, _, body = chunk.partition("\n")
            row = {"source": source, "kernel": name.strip(),
                   "tensor_core": len(re.findall(r"\b[IH]G?MMA\b", body)),
                   "idp": len(re.findall(r"\bIDP\b", body))}
            rows.append(row)
            print(f"sass {source}: {row['kernel'][:70]} "
                  f"tensor_core={row['tensor_core']} idp={row['idp']}",
                  flush=True)
    for source, kernel in TENSOR_CORE_KERNELS.items():
        found = [r for r in rows if r["source"] == source
                 and kernel in r["kernel"]]
        check(bool(found), f"no {kernel} in {source}'s SASS")
        for r in found:
            check(r["tensor_core"] > 0 and r["idp"] == 0,
                  f"{r['kernel']}: {r['tensor_core']} tensor-core and "
                  f"{r['idp']} IDP instructions")


def vae_workload(seed=2, n=VAE_N, length=VAE_KW["input_length"]):
    """bench_all.py's VAE training set: one smooth class, f32."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, length)
    return (rng.normal(1, .08, (n, 1)) * np.sin(2 * np.pi * 3 * t)
            + rng.normal(0, .02, (n, length))).astype(np.float32)


def rel_err(got, ref):
    """max |got - ref| over max |ref| (the error against the output's scale)."""
    ref = ref.double()
    return ((got.double() - ref).abs().max() / ref.abs().max().clamp_min(
        1e-30)).item()


def bn_inputs(shape, gen, dev):
    nb, nc, nl = shape
    return ((torch.randn(nb, nc, nl, generator=gen) * 1.5 + 0.3).to(dev),
            (torch.rand(nc, generator=gen) + 0.5).to(dev),
            (torch.randn(nc, generator=gen) * 0.5).to(dev),
            torch.randn(nb, nc, nl, generator=gen).to(dev))


def compare_bn(shape, act, gen, dev):
    """K2 and K3 against their twins on the same inputs; returns the max
    absolute error.  Tolerance 1e-4 of each output's scale: f32 sums over
    B*L = 8k-32k terms taken in the block's tree order, not torch's."""
    x, g, b, dout = bn_inputs(shape, gen, dev)
    out, mean, var = bn.bn_act_fwd(x, g, b, BN_EPS, act)
    dx, dg, db = bn.bn_act_bwd(x, g, b, mean, var, dout, BN_EPS, act)
    torch.cuda.synchronize()
    ref = bn.bn_act_fwd_plain(x, g, b, BN_EPS, act)
    ref += bn.bn_act_bwd_plain(x, g, b, mean, var, dout, BN_EPS, act)
    names = ("out", "mean", "var", "dx", "dgamma", "dbeta")
    got = (out, mean, var, dx, dg, db)
    errs = {n: rel_err(a, r) for n, a, r in zip(names, got, ref)}
    for n, a in zip(names, got):
        check(bool(torch.isfinite(a).all()), f"BN {shape} {act}: {n} not finite")
    print(json.dumps({"phase": "bn_vs_plain", "shape": shape, "act": act,
                      "k2_cluster": bn.k2_cluster_size(*shape),
                      "rel_err_of_scale": errs}), flush=True)
    for n, e in errs.items():
        check(e <= 1e-4, f"BN {shape} {act}: {n} error {e} > 1e-4 of scale")
    return (max((a - r).abs().max().item() for a, r in zip(got[:3], ref[:3])),
            max((a - r).abs().max().item() for a, r in zip(got[3:], ref[3:])))


def compare_reparam(shape, gen, dev, mu_offset=0):
    """K4 and K6's backward kernel against the plain twins, and K6's
    gradients against autograd through the plain forward, for two kinds
    of upstream gradient: dz and dkl dense, and dz non-contiguous with dkl
    the stride-0 expand that ``kl.mean()``'s gradient arrives as.  With
    ``mu_offset`` mu starts that many floats past an aligned base, off the
    vector path.  Tolerance 1e-5 of scale: elementwise exp and a k-term
    f32 row sum."""
    n, k = shape
    flat = (torch.randn(n * k + mu_offset, generator=gen) * 0.8).to(dev)
    mu = flat[mu_offset:].view(n, k)
    lv, eps, dz = (torch.randn(3, *shape, generator=gen) * 0.8).to(dev)
    dkl = torch.randn(n, generator=gen).to(dev)
    upstream = {"dense": (dz, dkl),
                "strided": (dz.T.contiguous().T,
                            torch.full((), 1.0 / n, device=dev).expand(n))}
    z, kl = kernels.reparam_kl(mu, lv, eps)
    z_p, kl_p = kernels.reparam_kl_plain(mu, lv, eps)
    errs = {"z": rel_err(z, z_p), "kl": rel_err(kl, kl_p)}
    for label, grads in upstream.items():
        got = []
        for fn in (kernels.fused_reparam_kl, kernels.reparam_kl_plain):
            m, v = mu.clone().requires_grad_(), lv.clone().requires_grad_()
            torch.autograd.backward(fn(m, v, eps), grads)
            got.append((m.grad, v.grad))
        got.append(kernels.reparam_kl_bwd(mu, lv, eps, *grads))
        ref = kernels.reparam_kl_bwd_plain(mu, lv, eps, *grads)
        for i, name in enumerate(("dmu", "dlogvar")):
            errs[f"{name} {label}"] = rel_err(got[0][i], got[1][i])
            errs[f"{name} {label} kernel vs twin"] = rel_err(got[2][i], ref[i])
    torch.cuda.synchronize()
    align = next(a for a in (16, 8, 4) if mu.data_ptr() % a == 0)
    print(json.dumps({"phase": "reparam_vs_plain", "shape": shape,
                      "mu_offset": mu_offset,
                      "plan": kernels.reparam_plan(n, k, align),
                      "rel_err_of_scale": errs}), flush=True)
    for name, e in errs.items():
        check(e <= 1e-5, f"reparam {shape}: {name} error {e} > 1e-5 of scale")
    return (max((z - z_p).abs().max().item(), (kl - kl_p).abs().max().item()),
            max((a - r).abs().max().item() for a, r in zip(got[2], ref)))


def compare_after_linear(gen, dev, reps=20):
    """K4, K6's backward and K5 launched straight after the Linear that
    writes one of their inputs, as ``fc_logvar`` (or the decoder's first
    product, for dz) does on the path.  They are launched as programmatic
    dependents and may start before the product ends, so each must wait
    for its writes; every rep gets a new input, so a read of the buffer's
    earlier contents would differ from the twin.  Tolerance 1e-5 of scale
    (K5's noise itself bit-equal).  Returns the max abs error."""
    n, k, hidden = VAE_BATCH, VAE_KW["latent_dim"], VAE_KW["hidden_fc"]
    fc = torch.nn.Linear(hidden, k).to(dev).requires_grad_(False)
    mu, lv, eps = (torch.randn(3, n, k, generator=gen) * 0.8).to(dev)
    dkl = torch.full((), 1.0 / n, device=dev).expand(n)
    hs = [torch.randn(n, hidden, generator=gen).to(dev) for _ in range(reps)]
    torch.cuda.synchronize()
    got = [(kernels.reparam_kl(mu, fc(h), eps),
            kernels.reparam_kl_bwd(mu, lv, eps, fc(h), dkl),
            kernels.reparam_kl_sample(mu, fc(h), i, return_eps=True))
           for i, h in enumerate(hs)]
    torch.cuda.synchronize()
    errs, worst, eps_equal = {"k4": 0.0, "k6_bwd": 0.0, "k5": 0.0}, 0.0, True
    for i, (h, (k4, k6, k5)) in enumerate(zip(hs, got)):
        out = fc(h)
        refs = {"k4": kernels.reparam_kl_plain(mu, out, eps),
                "k6_bwd": kernels.reparam_kl_bwd_plain(mu, lv, eps, out, dkl),
                "k5": kernels.reparam_kl_sample_plain(mu, out, i)}
        for name, res in (("k4", k4), ("k6_bwd", k6), ("k5", k5)):
            for a, r in zip(res, refs[name]):
                errs[name] = max(errs[name], rel_err(a, r))
                worst = max(worst, (a - r).abs().max().item())
        eps_equal &= bool(torch.equal(k5[2], refs["k5"][2]))
    print(json.dumps({"phase": "reparam_after_linear", "reps": reps,
                      "rel_err_of_scale": errs, "k5_eps_bit_equal":
                      eps_equal}), flush=True)
    for name, e in errs.items():
        check(e <= 1e-5, f"{name} after a Linear: error {e} > 1e-5 of scale")
    check(eps_equal, "K5 after a Linear: its noise differs from the twin's")
    return worst


def path_bn_shapes(dev):
    """The (B, C, L) each BatchNorm of the entry model sees in a train step."""
    model = ConvVAE1D(**VAE_KW).to(dev).train()
    shapes = []
    for mod in model.modules():
        if isinstance(mod, BatchNormAct):
            mod.register_forward_hook(
                lambda m, i, o: shapes.append(tuple(i[0].shape)))
    x = torch.zeros(VAE_BATCH, VAE_KW["input_length"], device=dev)
    with torch.no_grad():
        model(x, torch.zeros(VAE_BATCH, VAE_KW["latent_dim"], device=dev))
    return shapes


def grads_of(model, cfg, xb, eps):
    model.train()
    model.zero_grad(set_to_none=True)
    loss = vae_trainer.step_loss(model, cfg, xb, eps)
    loss.backward()
    return loss.item(), {n: p.grad.detach().double().cpu()
                         for n, p in model.named_parameters()}


def step_vs_cpu_f64(cfg, x_np, dev):
    """One train step from identical parameters, batch and eps: the card in
    f32 against the port's CPU path in f64.  cuDNN's and cuBLAS's backward
    sum in their own order, so the bounds are relative: loss 1e-4, and
    each gradient's error 1e-3 of its norm (or of 1e-3 of the whole
    gradient's norm, for the conv biases ahead of a BatchNorm, whose exact
    gradient is 0)."""
    model = ConvVAE1D(**VAE_KW, generator=torch.Generator().manual_seed(1))
    ref_model = copy.deepcopy(model).double()
    mean, std = x_np.mean(0), x_np.std(0) + 1e-12
    xb = (x_np[:VAE_BATCH] - mean) / std
    eps = np.random.default_rng(3).normal(
        size=(VAE_BATCH, VAE_KW["latent_dim"]))
    loss, g = grads_of(model.to(dev), cfg,
                       torch.as_tensor(xb, dtype=torch.float32, device=dev),
                       torch.as_tensor(eps, dtype=torch.float32, device=dev))
    loss_r, g_r = grads_of(ref_model, cfg, torch.as_tensor(xb).double(),
                           torch.as_tensor(eps))
    total = math.sqrt(sum(float(v.norm()) ** 2 for v in g_r.values()))
    errs = {n: float((g[n] - g_r[n]).norm())
            / max(float(g_r[n].norm()), 1e-3 * total) for n in g_r}
    loss_rel = abs(loss - loss_r) / abs(loss_r)
    worst = max(errs, key=errs.get)
    print(json.dumps({"phase": "train_step_vs_cpu_f64", "loss": loss,
                      "loss_cpu_f64": loss_r, "loss_rel_err": loss_rel,
                      "worst_grad": worst, "worst_grad_err": errs[worst],
                      "grad_norm_cpu_f64": total}), flush=True)
    check(loss_rel <= 1e-4, f"train-step loss differs from CPU f64 by {loss_rel}")
    check(errs[worst] <= 1e-3, f"gradient {worst} differs from CPU f64 by "
          f"{errs[worst]} of its norm")


def entry_forward_vs_cpu_f64(dev):
    """__graft_entry__.entry()'s forward and cosine loss on 64 spectra."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (64, VAE_KW["input_length"]))
    eps = rng.normal(size=(64, VAE_KW["latent_dim"]))
    model = ConvVAE1D(**VAE_KW).eval()
    ref_model = copy.deepcopy(model).double()
    out = []
    for m, dt, d in ((model.to(dev), torch.float32, dev),
                     (ref_model, torch.float64, "cpu")):
        xt = torch.as_tensor(x, dtype=dt, device=d)
        with torch.no_grad():
            x_rec, mu, lv = m(xt, torch.as_tensor(eps, dtype=dt, device=d))
            loss = beta_vae_loss(xt, x_rec, mu, lv, loss_type="cosine")[0]
        out.append((x_rec.cpu(), loss.item()))
    (rec, loss), (rec_r, loss_r) = out
    rec_err, loss_rel = rel_err(rec, rec_r), abs(loss - loss_r) / abs(loss_r)
    print(json.dumps({"phase": "entry_forward_vs_cpu_f64",
                      "x_rec_rel_err_of_scale": rec_err, "cosine_loss": loss,
                      "cosine_loss_cpu_f64": loss_r,
                      "loss_rel_err": loss_rel}), flush=True)
    check(bool(torch.isfinite(rec).all())
          and rec.shape == (64, VAE_KW["input_length"]),
          f"entry forward: bad output {tuple(rec.shape)}")
    check(rec_err <= 1e-4, f"entry forward differs from CPU f64 by {rec_err}")
    check(loss_rel <= 1e-4, f"entry cosine loss differs by {loss_rel}")


KERNEL_GROUPS = (("K2/K3 bn_act", ("bn_act",)),
                 ("K5 reparam_kl_sample", ("reparam_kl_sample",)),
                 ("K6 reparam_kl_bwd", ("reparam_kl_bwd",)),
                 ("K4 reparam_kl", ("reparam_kl",)),
                 ("conv (cuDNN)", ("conv", "cudnn", "dgrad", "wgrad",
                                   "fprop")),
                 ("gemm (cuBLAS)", ("gemm", "gemv", "cutlass", "splitk")),
                 ("Adam (foreach)", ("multi_tensor", "foreach")),
                 ("copy (H2D/D2H)", ("memcpy",)),
                 ("generator draws", ("distribution", "randperm")),
                 ("activation (ELU/GELU)", ("elu_kernel", "gelu_kernel")),
                 ("reduce", ("reduce",)), ("elementwise", ("elementwise",)))
# the host calls that launch a kernel, to hold the trace's kernel count to
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def breakdown(fn, reps=10, phase="train_step_breakdown", unit="step"):
    """Where the time of ``fn()`` goes, from a torch.profiler trace of
    ``reps`` calls: device time by kernel group per ``unit``, the device's
    idle share of the wall time, and the host's launch calls beside the
    kernels the trace holds (equal when the trace is complete)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device events minus the ranges user annotations draw on the device
    # timeline (e.g. "Optimizer.step#Adam.step", which spans Adam's
    # kernels); kernel names hold '#' too, in their lambdas' names
    # ("...::{lambda()#1}..."), but never in their first word
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not re.match(r"[\w.]+#", e.key)]
    total_ms = sum(e.self_device_time_total for e in kern) / 1e3
    groups = {}
    for e in kern:
        name = e.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + e.self_device_time_total / 1e3 / reps,
                         n + e.count / reps)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    line = {"phase": phase, f"{unit}s": reps,
            f"wall_ms_per_{unit}": wall_ms / reps,
            f"device_ms_per_{unit}": total_ms / reps,
            "device_idle_share": 1.0 - total_ms / wall_ms if wall_ms else None,
            f"kernels_per_{unit}": sum(e.count for e in kern
                                       if "memcpy" not in e.key.lower()
                                       and "memset" not in e.key.lower())
            / reps,
            f"launch_calls_per_{unit}": sum(
                e.count for e in prof.key_averages()
                if e.key in LAUNCH_CALLS) / reps,
            f"groups_ms_and_launches_per_{unit}": groups,
            "top_kernels": [(e.key[:80], e.count // reps,
                             e.self_device_time_total / 1e3 / reps)
                            for e in top],
            "top_host_ops_self_ms": [(e.key[:60], e.count // reps,
                                      e.self_cpu_time_total / 1e3 / reps)
                                     for e in host]}
    print(json.dumps(line), flush=True)
    return line


def library_bn(x, g, b, act):
    """One PyTorch formulation of K2: batch_norm in training mode, then the
    activation.  Timed as a yardstick only; the port never calls it."""
    y = F.batch_norm(x, None, None, g, b, training=True, eps=BN_EPS)
    return bn.apply_act(y, act)


def time_bn(shapes, gen, dev, bw, f32_rate):
    """Per-shape K2/K3 records summed over one train step's six shapes.
    Each kernel, its twin and its library call are timed twice: over
    rotating inputs that together exceed twice the L2 (``*_ms``: each call
    reads its inputs from device memory, as the bound is priced) and on
    one input, L2-warm as the train step sees its activations
    (``*_warm_ms``)."""
    keys = ("ms", "warm_ms", "plain_ms", "plain_warm_ms", "library_ms",
            "library_warm_ms", "bound_ms", "call_ms")
    tot = {f"{kern}_{key}": 0.0 for kern in ("k2", "k3") for key in keys}
    bound_by = {"k2": set(), "k3": set()}
    for shape in shapes:
        x, g, b, dout = bn_inputs(shape, gen, dev)
        out, mean, var = bn.bn_act_fwd(x, g, b)
        n = x.numel()
        nc = shape[1]
        count = max(2, math.ceil(2 * L2_BYTES / (8 * n)))   # x and out
        xs = [x] + [x + 1e-3 * i for i in range(1, count)]
        # K3 reads x and dout and writes dx; its library call runs
        # autograd back through F.batch_norm + ELU, one graph an input
        grads = [(a, dout + 1e-3 * i) for i, a in enumerate(xs)]
        graphs = {}
        for a, d in grads:
            xr, gr, br = (t.clone().requires_grad_() for t in (a, g, b))
            graphs[id(a)] = (library_bn(xr, gr, br, "elu"), (xr, gr, br))

        def k3_library(a, d):
            y, leaves = graphs[id(a)]
            return torch.autograd.grad(y, leaves, d, retain_graph=True)

        def k3_plain(a, d):
            return bn.bn_act_bwd_plain(a, g, b, mean, var, d, BN_EPS, "elu")

        k2 = (8 * n + 16 * nc, K2_OPS * n)
        k3 = (12 * n + 24 * nc, K3_OPS * n)
        row = {"shape": shape, "rotated_inputs": count,
               "k2_ms": int8_probe.device_ms(
                   lambda a: bn.bn_act_fwd(a, g, b), xs, 2 * count),
               "k2_warm_ms": device_ms(lambda: bn.bn_act_fwd(x, g, b)),
               "k2_plain_ms": int8_probe.device_ms(
                   lambda a: bn.bn_act_fwd_plain(a, g, b, BN_EPS, "elu"), xs,
                   2 * count),
               "k2_plain_warm_ms": device_ms(
                   lambda: bn.bn_act_fwd_plain(x, g, b, BN_EPS, "elu")),
               "k2_library_ms": int8_probe.device_ms(
                   lambda a: library_bn(a, g, b, "elu"), xs, 2 * count),
               "k2_library_warm_ms": device_ms(
                   lambda: library_bn(x, g, b, "elu")),
               "k2_call_ms": median_ms(lambda: bn.bn_act_fwd(x, g, b), 3, 21),
               "k3_cluster": bn.k2_cluster_size(*shape),
               "k3_ms": int8_probe.device_ms(
                   lambda ad: bn.bn_act_bwd(ad[0], g, b, mean, var, ad[1]),
                   grads, 2 * count),
               "k3_warm_ms": device_ms(
                   lambda: bn.bn_act_bwd(x, g, b, mean, var, dout)),
               "k3_plain_ms": int8_probe.device_ms(
                   lambda ad: k3_plain(*ad), grads, 2 * count),
               "k3_plain_warm_ms": device_ms(lambda: k3_plain(x, dout)),
               "k3_library_ms": int8_probe.device_ms(
                   lambda ad: k3_library(*ad), grads, 2 * count),
               "k3_library_warm_ms": device_ms(
                   lambda: k3_library(x, dout)),
               "k3_call_ms": median_ms(
                   lambda: bn.bn_act_bwd(x, g, b, mean, var, dout), 3, 21)}
        del xs, grads, graphs
        for key, (nbytes, ops) in (("k2", k2), ("k3", k3)):
            bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * ops / f32_rate
            row[f"{key}_bound_ms"] = max(bytes_ms, ops_ms)
            bound_by[key].add("bytes" if bytes_ms >= ops_ms else "operations")
        print(json.dumps({"phase": "bn_timing", **row}), flush=True)
        for key in tot:
            tot[key] += row[key]
    return tot, {k: "/".join(sorted(v)) for k, v in bound_by.items()}


def launch_floor_ms(dev):
    """Device ms of one launch of the library's empty kernel through the
    same ctypes path as every kernel: the least any launch of the port
    costs on this card.  None in an older tree of the package, which has
    no empty kernel."""
    noop = getattr(kernels, "noop", None)
    return None if noop is None else device_ms(lambda: noop(dev))


def bound_of(nbytes, ops, bw, f32_rate):
    bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * ops / f32_rate
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def time_reparam_train(dev, gen, bw, f32_rate):
    """K4 and K6's backward at the train batch (64, 16), L2-warm as the
    train step sees them, each beside its bound, its twin (for K6 the
    eager backward it replaced) and the launch floor; K6's backward also
    through autograd (``fused_reparam_kl``), as the train step runs it;
    and the chained pair the forward sits in, the ``fc_logvar`` Linear
    then K4 on its output.  K6's kernel and twin are None in an older tree
    of the package, whose backward is eager (its autograd time is then
    the eager one's)."""
    n, k = VAE_BATCH, VAE_KW["latent_dim"]
    mu, lv, eps, dz = (torch.randn(4, n, k, generator=gen) * 0.8).to(dev)
    dkl = torch.full((), 1.0 / n, device=dev).expand(n)   # kl.mean()'s
    m, v = mu.clone().requires_grad_(), lv.clone().requires_grad_()
    z, kl = kernels.fused_reparam_kl(m, v, eps)
    bwd = getattr(kernels, "reparam_kl_bwd", None)
    bwd_plain = getattr(kernels, "reparam_kl_bwd_plain", None)
    fc = torch.nn.Linear(VAE_KW["hidden_fc"], k).to(dev)
    h = torch.randn(n, VAE_KW["hidden_fc"], generator=gen).to(dev)
    line = {
        "shape": (n, k), "launch_floor_ms": launch_floor_ms(dev),
        "k4_ms": device_ms(lambda: kernels.reparam_kl(mu, lv, eps)),
        "k4_call_ms": median_ms(lambda: kernels.reparam_kl(mu, lv, eps), 3,
                                21),
        "k4_plain_ms": device_ms(lambda: kernels.reparam_kl_plain(mu, lv,
                                                                  eps)),
        **{f"k4_{key}": val for key, val in bound_of(
            16 * n * k + 4 * n, K4_OPS * n * k, bw, f32_rate).items()},
        "k4_library_ms": None,
        "k4_library_reason": "no single PyTorch call computes z and the "
                             "per-sample KL",
        "k6_bwd_ms": None if bwd is None else device_ms(
            lambda: bwd(mu, lv, eps, dz, dkl)),
        "k6_bwd_call_ms": None if bwd is None else median_ms(
            lambda: bwd(mu, lv, eps, dz, dkl), 3, 21),
        "k6_bwd_plain_ms": None if bwd_plain is None else device_ms(
            lambda: bwd_plain(mu, lv, eps, dz, dkl)),
        "k6_bwd_autograd_ms": device_ms(lambda: torch.autograd.grad(
            (z, kl), (m, v), (dz, dkl), retain_graph=True)),
        # mu, lv, eps, dz read, one dkl value (stride 0), dmu, dlv written
        **{f"k6_bwd_{key}": val for key, val in bound_of(
            24 * n * k + 4, K6_OPS * n * k, bw, f32_rate).items()},
        "k6_bwd_library_ms": None,
        "k6_bwd_library_reason": "no single PyTorch call computes both "
                                 "gradients; autograd through the plain "
                                 "forward is the eager backward's launches",
    }
    with torch.no_grad():
        line["fc_logvar_ms"] = device_ms(lambda: fc(h))
        line["fc_logvar_then_k4_ms"] = device_ms(
            lambda: kernels.reparam_kl(mu, fc(h), eps))
        # the same Linear writing dz, then K6's backward
        line["fc_then_k6_bwd_ms"] = None if bwd is None else device_ms(
            lambda: bwd(mu, lv, eps, fc(h), dkl))
    print(json.dumps({"phase": "reparam_train_timing", **line}), flush=True)
    return line


# --- the decision slice -----------------------------------------------------

def compare_sample(shape, gen, dev, seed=0x5EED_0123_4567_89AB, offset=7):
    """K5 against its plain twin on the same mu, logvar, seed and offset.
    The twin reproduces the kernel's Philox bits and takes them through
    the same f32 log, cos and sqrt, so the kernel's own noise must equal
    the twin's bit for bit, and z and KL must be within 1e-6 of their
    scale (exp, a fused multiply-add, the row sum's order).  The same
    seed must give identical output, another seed or offset other output.
    Returns (max abs error of z and KL, the kernel's noise)."""
    mu, lv = (torch.randn(2, *shape, generator=gen) * 0.8).to(dev)
    z, kl, eps = kernels.reparam_kl_sample(mu, lv, seed, offset,
                                           return_eps=True)
    z_p, kl_p, eps_p = kernels.reparam_kl_sample_plain(mu, lv, seed, offset)
    z2, kl2 = kernels.reparam_kl_sample(mu, lv, seed, offset)
    z_seed = kernels.reparam_kl_sample(mu, lv, seed + 1, offset)[0]
    z_off = kernels.reparam_kl_sample(mu, lv, seed, offset + 1)[0]
    torch.cuda.synchronize()
    errs = {"z": rel_err(z, z_p), "kl": rel_err(kl, kl_p)}
    eps_equal = bool(torch.equal(eps, eps_p))
    same = bool(torch.equal(z, z2) and torch.equal(kl, kl2))
    keyed = not (torch.equal(z, z_seed) or torch.equal(z, z_off))
    print(json.dumps({"phase": "reparam_sample_vs_plain", "shape": shape,
                      "plan": kernels.reparam_plan(*shape, sampled=True),
                      "eps_bit_equal": eps_equal,
                      "eps_max_abs_diff": (eps - eps_p).abs().max().item(),
                      "rel_err": errs, "same_seed_identical": same,
                      "other_seed_or_offset_differs": keyed}), flush=True)
    for n, e in errs.items():
        check(e <= 1e-6, f"K5 {shape}: {n} error {e} > 1e-6")
    check(eps_equal, f"K5 {shape}: its noise differs from the twin's")
    check(same, f"K5 {shape}: the same seed gave different output")
    check(keyed, f"K5 {shape}: another seed or offset gave the same output")
    return max((z - z_p).abs().max().item(),
               (kl - kl_p).abs().max().item()), eps


def noise_statistics(eps):
    """The kernel's noise against N(0, 1): over 1,048,576 draws the mean's
    standard error is 1e-3, the variance's 1.4e-3, and the KS distance's
    99.9 % point 1.95e-3; neighbouring columns and rows uncorrelated."""
    from scipy import stats
    e = eps.double()
    flat = e.flatten()

    def corr(a, b):
        return torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1]

    line = {"phase": "reparam_sample_noise", "draws": flat.numel(),
            "mean": flat.mean().item(), "var": flat.var().item(),
            "ks": float(stats.kstest(flat.cpu().numpy(), "norm").statistic),
            "corr_columns": corr(e[:, :-1], e[:, 1:]).item(),
            "corr_rows": corr(e[:-1], e[1:]).item(),
            "max_abs": flat.abs().max().item()}
    print(json.dumps(line), flush=True)
    check(abs(line["mean"]) < 5e-3, f"K5 noise mean {line['mean']}")
    check(abs(line["var"] - 1.0) < 1e-2, f"K5 noise variance {line['var']}")
    check(line["ks"] < 2e-3, f"K5 noise KS distance {line['ks']}")
    for key in ("corr_columns", "corr_rows"):
        check(abs(line[key]) < 5e-3, f"K5 noise {key} {line[key]}")


def decision_workload(seed, n_cal, n_test, freq=3):
    """bench_all.py:234-241's VAE-SIMCA spectra (f32): calibration and test
    draws of one smooth class; ``freq`` 3 is the benchmark's."""
    rng = np.random.default_rng(seed)
    length = VAE_KW["input_length"]
    t = np.linspace(0, 1, length)
    base = np.sin(2 * np.pi * freq * t)
    x_cal = (rng.normal(1, .08, (n_cal, 1)) * base
             + rng.normal(0, .02, (n_cal, length))).astype(np.float32)
    x_test = (rng.normal(1, .2, (n_test, 1)) * base
              + rng.normal(0, .05, (n_test, length))).astype(np.float32)
    return x_cal, x_test


def train_and_calibrate(x_cal, seed):
    """``bench_all.py``'s 3-epoch training of the entry model, then the
    deterministic thresholds and ``fit_vaesimca`` with its defaults.
    Returns (model, trained bundle, calibrated bundle, VAE-SIMCA model)."""
    cfg = vae_trainer.TrainConfig(epochs=DEC_EPOCHS, batch_size=VAE_BATCH,
                                  loss_type="cosine")
    model = ConvVAE1D(**VAE_KW, generator=torch.Generator().manual_seed(seed))
    trained = vae_trainer.train_vae(model, x_cal, x_cal[:VAE_BATCH], cfg,
                                    seed=seed).bundle
    bundle = vae_decision.fit_thresholds(model, trained, x_cal,
                                         loss_type="cosine")
    return model, trained, bundle, vaesimca.fit_vaesimca(model, bundle, x_cal)


def make_scorers(model, bundle, vs, chunk):
    """One resident ``VAEScorer`` per decision variant (pinned 'f' too)."""
    return {label: VAEScorer(
        model, bundle, variant=label.removesuffix("_pinned"),
        loss_type="cosine", chunk_size=chunk, **extra,
        vaesimca_model=vs if label == "vaesimca" else None)
        for label, extra in VARIANTS}


@contextlib.contextmanager
def cudnn_nondeterministic():
    """cuDNN's default algorithms, whose sums run in a varying order, for
    a measurement of what the package's deterministic setting costs; the
    setting comes back after.  This script decides in one thread only."""
    torch.backends.cudnn.deterministic = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = True


def pinned_f_split(scorer, prepared, reps=3):
    """Where one chunk of pinned 'f' spends its time, medians in ms: the
    decision on the device (network outputs, events), the pageable copy of
    the standardized spectra, reconstructions and mu to the host, and the
    host's float64 statistics (``qhf_batch_host``)."""
    split = {"device_ms": [], "fetch_ms": [], "host_stats_ms": []}
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = scorer._decide(*prepared[0][0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in res.items()}
        t2 = time.perf_counter()
        scorer._post(out)
        t3 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[key].append(1e3 * dt)
    line = {k: statistics.median(v[1:]) for k, v in split.items()}
    line["fetched_mb"] = sum(v.numel() * v.element_size()
                             for v in res.values()) / 1e6
    return line


def accept_rate(accept):
    """The share of a one-class test set accepted: the screen's
    sensitivity, through the port's conformity metrics."""
    acc = np.asarray(accept).astype(np.int64)
    return metrics.conformity_metrics(np.zeros(acc.shape[0]), acc, 0,
                                      device="cpu").sensitivity.item() / 100


def check_limits(label, values):
    for key, v in values.items():
        v = torch.as_tensor(v)
        check(bool(torch.isfinite(v).all() and (v > 0).all()),
              f"{label}: {key} not finite and > 0: {v.tolist()}")


def entry_sampled_forward(dev):
    """__graft_entry__.entry()'s eval forward with z sampled, as its
    ``rngs={'reparam': ...}`` does, through K5, and its cosine loss, on 64
    spectra; against the port's CPU f64 forward with the same seed (its
    plain twin draws the same noise), to 1e-4 of scale.  Returns the
    number of K5 launches."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (64, VAE_KW["input_length"]))
    model = ConvVAE1D(**VAE_KW).eval()
    ref_model = copy.deepcopy(model).double()
    seed = vae_bundle.draw_seed(torch.Generator().manual_seed(1))
    before = kernels.reparam_kl_sample.launches
    out = []
    for m, dt, d in ((model.to(dev), torch.float32, dev),
                     (ref_model, torch.float64, "cpu")):
        with torch.inference_mode():
            xt = torch.as_tensor(x, dtype=dt, device=d)
            x_rec, mu, lv = m(xt, seed=seed)
            loss = beta_vae_loss(xt, x_rec, mu, lv, loss_type="cosine")[0]
        out.append((x_rec.cpu(), loss.item()))
    torch.cuda.synchronize()
    launches = kernels.reparam_kl_sample.launches - before
    (rec, loss), (rec_r, loss_r) = out
    rec_err, loss_rel = rel_err(rec, rec_r), abs(loss - loss_r) / abs(loss_r)
    print(json.dumps({"phase": "entry_sampled_forward", "k5_launches":
                      launches, "x_rec_rel_err_of_scale": rec_err,
                      "cosine_loss": loss, "cosine_loss_cpu_f64": loss_r,
                      "loss_rel_err": loss_rel}), flush=True)
    check(bool(torch.isfinite(rec).all())
          and rec.shape == (64, VAE_KW["input_length"]),
          "sampled entry forward: bad output")
    check(rec_err <= 1e-4, f"sampled entry forward differs by {rec_err}")
    check(loss_rel <= 1e-4, f"sampled entry loss differs by {loss_rel}")
    return launches


def to_cpu64(tree):
    """A bundle or VAE-SIMCA model on the CPU in float64 (integers kept)."""
    def conv(t):
        t = t.detach().cpu()
        return t.double() if t.is_floating_point() else t

    fields = {f: conv(getattr(tree, f)) for f in tree._fields
              if f != "state_dict"}
    if "state_dict" in tree._fields:
        fields["state_dict"] = {k: conv(v) for k, v in tree.state_dict.items()}
    return type(tree)(**fields)


def stats_rel_err(got, ref):
    """max over the non-accept outputs of rel_err."""
    return {k: rel_err(torch.as_tensor(got[k]), torch.as_tensor(ref[k]))
            for k in ref if k != "accept"}


def stacked_vs_single(model, x_multi):
    """The 3-class stacked screen against 3 single-class scorers: identical
    accepts and statistics within 1e-6 of scale (the same resident modules'
    arithmetic class by class)."""
    bundles, models = [], []
    for c in range(3):
        x_cal, _ = decision_workload(30 + c, DEC_N_CAL, 1, freq=3 + c)
        _, _, b, vs = train_and_calibrate(x_cal, seed=10 + c)
        bundles.append(b)
        models.append(vs)
    stacked = make_scorers(model, vae_bundle.stack_bundles(bundles),
                           vae_bundle.stack_bundles(models), DEC_CHUNK)
    singles = [make_scorers(model, b, vs, DEC_CHUNK)
               for b, vs in zip(bundles, models)]
    line = {"phase": "stacked_vs_single", "spectra": x_multi.shape[0]}
    for label, scorer in stacked.items():
        out = scorer.score(x_multi)
        check(out["accept"].shape == (x_multi.shape[0], 3),
              f"stacked {label}: accept shape {out['accept'].shape}")
        worst, rates = 0.0, []
        for c in range(3):
            single = singles[c][label].score(x_multi)
            col = {k: v[:, c] for k, v in out.items()}
            check(np.array_equal(col["accept"], single["accept"]),
                  f"stacked {label}: class {c} accepts differ from single")
            worst = max([worst, *stats_rel_err(col, single).values()])
            rates.append(accept_rate(single["accept"]))
        line[label] = {"stats_rel_err": worst, "accept_rate": rates}
        check(worst <= 1e-6, f"stacked {label}: statistics differ by {worst}")
    print(json.dumps(line), flush=True)


def card_vs_cpu_f64(model, trained, bundle, vs, x_cal, x_test):
    """The card's f32 calibration and screens against the port's CPU f64
    on the same trained bundle: thresholds and limits to 1e-3 (percentiles
    and bisected chi^2 quantiles of f32 statistics), the statistics of a
    4,096-spectrum screen (chunk 4,096 on both sides) to 1e-4 of scale
    (f32 convolutions, 3 to 4 layers deep), accepts equal on >= 99.9 % of
    spectra, >= 99 % for unpinned 'f', whose batch statistics (quirk Q3)
    move its boundary."""
    x_cal64, x64 = x_cal.astype(np.float64), x_test[:DEC_N_CPU].astype(
        np.float64)
    b64 = vae_decision.fit_thresholds(model, to_cpu64(trained), x_cal64,
                                      loss_type="cosine")
    vs64 = vaesimca.fit_vaesimca(model, b64, x_cal64)
    lims = {f: (getattr(bundle, f), getattr(b64, f)) for f in
            ("threshold", "threshold_q", "threshold_h", "threshold_f")}
    lims.update({f: (getattr(vs, f), getattr(vs64, f)) for f in
                 ("t2_limit", "q_limit", "d_limit")})
    lim_err = {k: abs(float(a) - float(b)) / abs(float(b))
               for k, (a, b) in lims.items()}
    card = make_scorers(model, bundle, vs, DEC_N_CPU)
    cpu = make_scorers(model, b64, vs64, DEC_N_CPU)
    screens = {}
    for label in card:
        got, ref = card[label].score(x_test[:DEC_N_CPU]), cpu[label].score(x64)
        screens[label] = {"stats_rel_err": stats_rel_err(got, ref),
                          "accept_agreement": float(
                              (got["accept"] == ref["accept"]).mean())}
    print(json.dumps({"phase": "decision_vs_cpu_f64",
                      "limit_rel_err": lim_err, "screens": screens}),
          flush=True)
    for k, e in lim_err.items():
        check(e <= 1e-3, f"{k} differs from the CPU f64 fit by {e}")
    for label, r in screens.items():
        for k, e in r["stats_rel_err"].items():
            check(e <= 1e-4, f"screen {label}: {k} differs from CPU f64 "
                  f"by {e}")
        floor = 0.99 if label == "f" else 0.999
        check(r["accept_agreement"] >= floor, f"screen {label}: accept "
              f"agreement {r['accept_agreement']} < {floor}")


def time_sample(shape, gen, dev, bw, f32_rate):
    """K5 and its twin on device, beside its bound: bytes 12 N k + 4 N,
    operations K5_OPS_PER_PAIR per element pair at the f32 rate."""
    n, k = shape
    mu, lv = (torch.randn(2, n, k, generator=gen) * 0.8).to(dev)
    eps = torch.randn(n, k, generator=gen).to(dev)
    fc = torch.nn.Linear(VAE_KW["hidden_fc"], k).to(dev).requires_grad_(False)
    h = torch.randn(n, VAE_KW["hidden_fc"], generator=gen).to(dev)
    bytes_ms = 1e3 * (12 * n * k + 4 * n) / bw
    ops_ms = 1e3 * K5_OPS_PER_PAIR * ((n * k + 1) // 2) / f32_rate
    line = {"shape": shape, "launch_floor_ms": launch_floor_ms(dev),
            "ms": device_ms(lambda: kernels.reparam_kl_sample(mu, lv, 1)),
            "call_ms": median_ms(lambda: kernels.reparam_kl_sample(mu, lv, 1),
                                 3, 21),
            "plain_ms": device_ms(
                lambda: kernels.reparam_kl_sample_plain(mu, lv, 1), 10),
            # the two-launch alternative: torch's own normals, then K4
            "randn_plus_k4_ms": device_ms(lambda: kernels.reparam_kl(
                mu, lv, torch.randn(n, k, device=dev))),
            "k4_given_eps_ms": device_ms(lambda: kernels.reparam_kl(
                mu, lv, eps)),
            # the chained pair of the sampled forward: fc_logvar, then K5
            "fc_logvar_ms": device_ms(lambda: fc(h)),
            "fc_logvar_then_ms": device_ms(
                lambda: kernels.reparam_kl_sample(mu, fc(h), 1)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "library_reason": "no single PyTorch call draws the noise and "
                              "forms z and the per-sample KL; torch.randn "
                              "then K4 is two launches (randn_plus_k4_ms)"}
    print(json.dumps({"phase": "reparam_sample_timing", **line}), flush=True)
    return line


def decision_phases(dev, card, bw, f32_rate):
    """Phases 9-12, the decision slice; returns K5's kernel record."""
    # 9. K5 against its plain twin at SAMPLE_SHAPES; the noise statistics
    #    of the screen chunk's 1,048,576 draws
    gen = torch.Generator().manual_seed(5)
    k5_err = 0.0
    for shape in SAMPLE_SHAPES:
        err, eps = compare_sample(shape, gen, dev)
        k5_err = max(k5_err, err)
        if shape == (DEC_N_TEST, VAE_KW["latent_dim"]):
            noise_statistics(eps)
        del eps

    # 10. the decision path, as a user calls it (numpy in, CUDA by
    #     default), with K5's launches read after each step
    x_cal, x_test = decision_workload(3, DEC_N_CAL, DEC_N_TEST)
    kernels.reparam_kl_sample.launches = 0
    model, trained, bundle, vs = train_and_calibrate(x_cal, seed=0)
    torch.cuda.synchronize()
    k5 = {"fit_thresholds": kernels.reparam_kl_sample.launches}
    sampled = vae_decision.fit_thresholds(
        model, trained, x_cal, loss_type="cosine",
        rng=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    k5["fit_thresholds_sampled"] = kernels.reparam_kl_sample.launches \
        - k5["fit_thresholds"]
    scorers = make_scorers(model, bundle, vs, DEC_CHUNK)
    before = kernels.reparam_kl_sample.launches
    screens, k9 = {}, {}
    for label, s in scorers.items():
        bn.bn_act_eval.launches = 0
        screens[label] = s.score(x_test)
        torch.cuda.synchronize()
        k9[label] = bn.bn_act_eval.launches
    k5["screens"] = kernels.reparam_kl_sample.launches - before
    k5["entry_forward"] = entry_sampled_forward(dev)
    k5_launches = kernels.reparam_kl_sample.launches
    lims = {"threshold": bundle.threshold, "threshold_q": bundle.threshold_q,
            "threshold_h": bundle.threshold_h,
            "threshold_f": bundle.threshold_f,
            "sampled_threshold": sampled.threshold,
            "sampled_threshold_q": sampled.threshold_q,
            "t2_limit": vs.t2_limit, "q_limit": vs.q_limit,
            "d_limit": vs.d_limit}
    print(json.dumps({"phase": "decision_main_path", "k5_launches": k5,
                      "k9_launches": k9,
                      "limits": {k: float(v) for k, v in lims.items()},
                      "accept_rate": {k: accept_rate(v["accept"])
                                      for k, v in screens.items()}}),
          flush=True)
    check(k5 == {"fit_thresholds": 0, "fit_thresholds_sampled": 1,
                 "screens": 0, "entry_forward": 1}, f"K5 launches {k5}")
    want = {k: n * DEC_N_TEST // DEC_CHUNK for k, n in K9_PER_CHUNK.items()}
    check(k9 == want, f"K9 launches {k9}, expected {want}")
    check_limits("decision", lims)
    for label, out in screens.items():
        for key, v in out.items():
            check(v.shape == (DEC_N_TEST,), f"{label}: {key} shape {v.shape}")
            check(bool(np.isfinite(v).all()), f"{label}: {key} not finite")
    x_multi = np.concatenate([decision_workload(
        40 + c, 1, DEC_N_MULTI // 3 + 1, freq=3 + c)[1]
        for c in range(3)])[:DEC_N_MULTI]
    stacked_vs_single(model, x_multi)

    # 11. the card (f32) against the port's CPU f64, same trained bundle
    card_vs_cpu_f64(model, trained, bundle, vs, x_cal, x_test)

    # 12. decision timings
    screen_ms = {label: median_ms(lambda s=s: s.score(x_test), 1, 3)
                 for label, s in scorers.items()}
    fit_ms = {
        "fit_thresholds_ms": median_ms(lambda: vae_decision.fit_thresholds(
            model, trained, x_cal, loss_type="cosine"), 1, 3),
        "fit_thresholds_sampled_ms": median_ms(
            lambda: vae_decision.fit_thresholds(
                model, trained, x_cal, loss_type="cosine",
                rng=torch.Generator().manual_seed(0)), 1, 3),
        "fit_vaesimca_ms": median_ms(lambda: vaesimca.fit_vaesimca(
            model, bundle, x_cal), 1, 3)}
    # the price of cuDNN's deterministic algorithms (the package's
    # setting), and what it buys: two runs of the same screen without it
    with cudnn_nondeterministic():
        nondet_ms = {label: median_ms(lambda s=scorers[label]: s.score(
            x_test), 1, 3) for label in ("d2_q", "vaesimca")}
        rerun = stats_rel_err(*(scorers["vaesimca"].score(x_test)
                                for _ in range(2)))
    print(json.dumps({"phase": "decision_timings", "card": card,
                      "spectra": DEC_N_TEST, "chunk": DEC_CHUNK,
                      "screen_ms": screen_ms,
                      "screen_ms_cudnn_nondeterministic": nondet_ms,
                      "vaesimca_rerun_rel_err_cudnn_nondeterministic": rerun,
                      "spectra_per_s": {k: DEC_N_TEST / (v / 1e3)
                                        for k, v in screen_ms.items()},
                      **fit_ms}), flush=True)
    # one vaesimca chunk: the profiler's breakdown, and its device time
    # (chunks queued behind a GPU sleep) beside one decided and fetched
    scorer = scorers["vaesimca"]
    prepared = scorer.prepare(x_test[:DEC_CHUNK])
    breakdown(lambda: scorer.score_prepared(prepared), reps=5,
              phase="vaesimca_chunk_breakdown", unit="chunk")
    chunk = {"device_ms": device_ms(lambda: scorer._decide(*prepared[0][0]),
                                    5),
             "call_ms": median_ms(lambda: scorer.score_prepared(prepared),
                                  1, 5)}
    with cudnn_nondeterministic():
        chunk["device_ms_cudnn_nondeterministic"] = device_ms(
            lambda: scorer._decide(*prepared[0][0]), 5)
    pinned = scorers["f_pinned"]
    print(json.dumps({"phase": "vaesimca_chunk_timing", "card": card,
                      "chunk": DEC_CHUNK, **chunk,
                      "f_pinned_chunk": pinned_f_split(
                          pinned, pinned.prepare(x_test[:DEC_CHUNK]))}),
          flush=True)
    k5_t = {n: time_sample((n, VAE_KW["latent_dim"]), gen, dev, bw, f32_rate)
            for n in (DEC_N_CAL, DEC_N_TEST)}
    path = k5_t[DEC_N_CAL]
    record = (
        {"name": "reparam_kl_sample", "route": "cuda",
         "source": "ocm_tpu_torch/csrc/reparam_sample.cu",
         "replaces": "ocm_tpu/ops/kernels.py:160", "launches": k5_launches,
         "max_abs_err": k5_err, "ms": path["ms"],
         "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"],
         "bound_by": path["bound_by"], "library_ms": None})
    check(all(math.isfinite(v) for v in (*screen_ms.values(), *fit_ms.values(),
                                         path["ms"], path["plain_ms"])),
          "a decision timing is not finite")
    return record, (model, bundle, vs, x_test, screens)


# --- the serving slice ------------------------------------------------------

def serving_data(seed=5, n=SRV_PER_CLASS, length=LENGTH):
    """The screened set, f64: ``n`` fresh draws of each class's recipe
    (``make_data``'s), then ``n`` of bench.py's off-class recipe, so that
    the accept matrices hold both decisions."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, length)
    parts = []
    for c in range(N_CLASSES):
        base = np.sin(2 * np.pi * (3 + c) * t) + 0.3 * c
        parts.append(rng.normal(1.0, 0.08, (n, 1)) * base
                     + rng.normal(0, 0.02, (n, length)))
    parts.append(rng.normal(0, 1, (n, length)) + np.sin(2 * np.pi * 3 * t))
    return np.concatenate(parts)


def camera_counts(x):
    """uint16 camera counts of spectra ``x`` (the raw-ingest mode's input)."""
    return np.clip(np.round(5000.0 * (x + 6.0)), 0, 65535).astype(np.uint16)


def prep_raw(x):
    """The raw-ingest scorer's preprocess_fn: SNV then SavGol(5, 2, 1)."""
    return snv_savgol(x, 5, 2, 1)


def launch_counts():
    return {"k1_f32": kernels.t2q_scores_multiclass.launches,
            "k1_bf16": kernels.t2q_scores_multiclass.launches_bf16,
            "k7": kernels.int8_tile_sum.launches,
            "k8": kernels.int8_gemm_s32.launches}


def zero_launch_counts():
    kernels.t2q_scores_multiclass.launches = 0
    kernels.t2q_scores_multiclass.launches_bf16 = 0
    kernels.int8_tile_sum.launches = kernels.int8_gemm_s32.launches = 0


def class_model(models, c):
    """Class ``c`` of a stacked SIMCA model."""
    return SIMCAModel(*(LimitResult(*(a[c] for a in v))
                        if isinstance(v, LimitResult) else v[c]
                        for v in models))


def agreement(got, ref):
    """(accept agreement, max |dred - dred_ref| / max |dred_ref|)."""
    return (float(np.mean(got["accept"] == ref["accept"])),
            float(np.abs(got["dred"] - ref["dred"]).max()
                  / np.abs(ref["dred"]).max()))


def int8_vs_plain(xq, w, gen, dev):
    """Phase 13, int8 part: K7 and K8 (tile sums) at the probe's shapes and
    a ragged one, K8 (the stored product) at the scoring shape, a ragged
    one and 7 columns; integer equality. Returns the max abs error (0)."""
    def rand(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8,
                             generator=gen).to(dev)

    cases = [(xq, w, t) for t in PROBE_TILES] + [
        (rand(1000, 203), rand(128, 203), 8)]
    err, lines = 0, []
    for x, ww, tile in cases:
        k7 = kernels.int8_tile_sum(x, tile)
        k8 = kernels.int8_gemm_s32(x, ww, tile)
        torch.cuda.synchronize()
        e7 = (k7.long() - kernels.int8_tile_sum_plain(x, tile).long()
              ).abs().max().item()
        e8 = (k8.long() - kernels.int8_gemm_s32_plain(x, ww, tile).long()
              ).abs().max().item()
        lines.append({"shape": tuple(x.shape), "tile": tile,
                      "k7_max_abs_err": e7, "k8_max_abs_err": e8})
        check(e7 == 0 and e8 == 0, f"K7/K8 at {tuple(x.shape)} tile {tile}: "
              f"errors {e7}, {e8}")
        err = max(err, e7, e8)
    m = 2 * (N_CLASSES * K + N_CLASSES)
    for n, length, cols in ((SRV_CHUNK, LENGTH, m), (1001, 203, m),
                            (4097, LENGTH, 7)):
        x, ww = rand(n, length), rand(cols, length)
        got = kernels.int8_gemm_s32(x, ww)
        torch.cuda.synchronize()
        e8 = (got.long() - kernels.int8_gemm_s32_plain(x, ww).long()
              ).abs().max().item()
        lines.append({"shape": (n, length, cols), "store": True,
                      "k8_max_abs_err": e8})
        check(e8 == 0 and got.shape == (n, cols),
              f"K8 store at {(n, length, cols)}: error {e8}")
    print(json.dumps({"phase": "int8_vs_plain", "cases": lines}), flush=True)
    return err


def make_serving_scorers(models, raw_models):
    """The four serving modes of examples/hsi_pipeline.py:131-141."""
    return {"f32": SIMCAScorer(models, chunk_size=SRV_CHUNK),
            "bf16": SIMCAScorer(models, chunk_size=SRV_CHUNK,
                                store_dtype=torch.bfloat16),
            "int8": SIMCAScorer(models, chunk_size=SRV_CHUNK,
                                store_dtype=torch.int8),
            "raw-u16": SIMCAScorer(raw_models, chunk_size=SRV_CHUNK,
                                   preprocess_fn=prep_raw)}


EXPECTED_SCREEN_LAUNCHES = {
    "f32": {"k1_f32": 2, "k1_bf16": 0, "k7": 0, "k8": 0},
    "bf16": {"k1_f32": 0, "k1_bf16": 2, "k7": 0, "k8": 0},
    "int8": {"k1_f32": 0, "k1_bf16": 0, "k7": 0, "k8": 2},
    "raw-u16": {"k1_f32": 2, "k1_bf16": 0, "k7": 0, "k8": 0}}


def serving_main_path(dev, models, raw_models, x, counts, xq, w, cal32,
                      labels, decisions):
    """Phase 14: the serving path as a user calls it (numpy in, numpy out),
    each mode driven with the launch counts zeroed just before it and read
    just after. Returns (scorers, screens, launches, streamed models)."""
    scorers = make_serving_scorers(models, raw_models)
    screens, launches = {}, {}
    for mode, scorer in scorers.items():
        zero_launch_counts()
        screens[mode] = scorer.score(counts if mode == "raw-u16" else x)
        torch.cuda.synchronize()
        launches[mode] = launch_counts()
    # the probe's path (K7 and K8 at each tile), and one single-class scorer
    zero_launch_counts()
    totals = int8_probe.scan(xq, w, PROBE_TILES)
    torch.cuda.synchronize()
    launches["probe"] = launch_counts()
    single = SIMCAScorer(class_model(models, 0), chunk_size=SRV_CHUNK,
                         center=scorers["f32"].center)
    zero_launch_counts()
    one = single.score(x)
    torch.cuda.synchronize()
    launches["single"] = launch_counts()
    # the streaming fit: the calibration set as 7 labelled batches of 300
    order = np.random.default_rng(7).permutation(len(labels))
    moms = streaming.moments_init_classes(N_CLASSES, LENGTH)
    for i in range(0, len(order), SRV_BATCH):
        idx = order[i:i + SRV_BATCH]
        moms = streaming.moments_update_classes(moms, cal32[idx], labels[idx],
                                                list(range(N_CLASSES)))
    streamed = streaming.fit_classes_moments(moms, K, solver="rsvd")
    torch.cuda.synchronize()
    print(json.dumps({"phase": "serving_launches", "launches": launches}),
          flush=True)
    for mode, want in EXPECTED_SCREEN_LAUNCHES.items():
        check(launches[mode] == want, f"{mode} screen launches "
              f"{launches[mode]} != {want}")
    check(launches["probe"] == {"k1_f32": 0, "k1_bf16": 0,
                                "k7": len(PROBE_TILES),
                                "k8": len(PROBE_TILES)},
          f"probe launches {launches['probe']}")
    check(launches["single"]["k1_f32"] == 2,
          f"single-class launches {launches['single']}")

    line = {"phase": "serving_main_path", "spectra": x.shape[0],
            "chunk": SRV_CHUNK}
    for mode, out in screens.items():
        for key, v in out.items():
            check(v.shape == (x.shape[0], N_CLASSES),
                  f"{mode}: {key} shape {v.shape}")
            check(bool(np.isfinite(v).all()), f"{mode}: {key} not finite")
        check(all(out[k].dtype == np.float32 for k in ("dred", "t2", "q")),
              f"{mode}: statistics are not float32")
        line[f"{mode}_accept_rate"] = out["accept"].mean(0).tolist()
    # f32 against predict_classes on the same pre-centered set
    center = scorers["f32"].center
    offset = torch.as_tensor(center, device=dev)
    acc_pc = predict_classes(models, torch.as_tensor(x - center, device=dev),
                             x_offset=offset)[0].T.cpu().numpy()
    line["f32_vs_predict_classes"] = float(
        np.mean(acc_pc == screens["f32"]["accept"]))
    check(line["f32_vs_predict_classes"] >= 0.999, "f32 screen against "
          f"predict_classes: {line['f32_vs_predict_classes']}")
    for mode in ("bf16", "int8"):
        agree, dred = agreement(screens[mode], screens["f32"])
        line[f"{mode}_vs_f32"] = {"accept": agree, "dred_of_max": dred}
        check(agree >= 0.995, f"{mode} accepts vs f32 {agree} < 0.995")
        check(dred <= 3e-2, f"{mode} dred vs f32 {dred} > 3e-2 of max")
    xp = prep_raw(torch.as_tensor(counts, device=dev).to(torch.float32))
    host = SIMCAScorer(raw_models, chunk_size=SRV_CHUNK).score(
        xp.cpu().numpy())
    agree, dred = agreement(screens["raw-u16"], host)
    line["raw_vs_host_prep"] = {"accept": agree, "dred_of_max": dred}
    check(agree >= 0.999, f"raw-u16 vs host prep {agree} < 0.999")
    col = {k: v[:, 0] for k, v in screens["f32"].items()}
    line["single_vs_column0"] = {
        "accept_equal": bool(np.array_equal(one["accept"], col["accept"])),
        "dred_of_max": agreement(one, col)[1]}
    check(line["single_vs_column0"]["accept_equal"]
          and line["single_vs_column0"]["dred_of_max"] <= 1e-6,
          f"single-class scorer vs column 0: {line['single_vs_column0']}")
    # prepared and sequential screens equal score bit for bit
    for mode, scorer in scorers.items():
        xin = counts if mode == "raw-u16" else x
        for how, out in (("score_prepared",
                          scorer.score_prepared(scorer.prepare(xin))),
                         ("prefetch_0", scorer.score(xin, prefetch=0))):
            same = all(np.array_equal(out[k], screens[mode][k])
                       for k in screens[mode])
            check(same, f"{mode}: {how} differs from score")
    line["prepared_and_prefetch_0_bit_equal"] = True
    # the probe's totals against the twins'
    want = {}
    for tile in PROBE_TILES:
        want[f"read t={tile}"] = int(xq.sum(dtype=torch.int64))
        want[f"gemm t={tile}"] = int(kernels.int8_gemm_s32_plain(
            xq, w, tile).sum(dtype=torch.int64))
    check(totals == want, f"probe totals {totals} != {want}")
    line["probe_totals_equal_twins"] = True
    # the streaming fit against fit_classes
    lim = {"t2_limit": (streamed.t2_res.limit, models.t2_res.limit),
           "q_limit": (streamed.q_res.limit, models.q_res.limit),
           "d_limit": (streamed.d_limit, models.d_limit)}
    line["streamed_limit_rel_err"] = {
        k: ((a - b).abs() / b.abs()).max().item() for k, (a, b) in lim.items()}
    stream_out = SIMCAScorer(streamed, chunk_size=SRV_CHUNK).score(x)
    line["streamed_vs_fit_classes_accept"] = agreement(
        stream_out, screens["f32"])[0]
    for k, e in line["streamed_limit_rel_err"].items():
        check(e <= 1e-3, f"streamed {k} differs from fit_classes by {e}")
    check(line["streamed_vs_fit_classes_accept"] >= 0.999,
          f"streamed accepts {line['streamed_vs_fit_classes_accept']}")
    # the bf16 VAE twin on the decision phases' bundle and test spectra
    model, bundle, vs, x_test, vae_f32 = decisions
    for variant in ("d2", "vaesimca"):
        out = VAEScorer(model, bundle, variant=variant, loss_type="cosine",
                        chunk_size=DEC_CHUNK, compute_dtype=torch.bfloat16,
                        vaesimca_model=vs if variant == "vaesimca" else None
                        ).score(x_test)
        agree = float(np.mean(out["accept"] == vae_f32[variant]["accept"]))
        line[f"vae_bf16_{variant}"] = {
            "accept_vs_f32": agree,
            "stats_rel_err": stats_rel_err(out, vae_f32[variant]),
            "accept_rate": accept_rate(out["accept"])}
        check(agree >= 0.98, f"bf16 VAE {variant} accepts vs f32 {agree}")
        check(all(v.dtype == np.float32 for k, v in out.items()
                  if k != "accept"), f"bf16 VAE {variant}: statistics not f32")
    print(json.dumps(line), flush=True)
    return scorers, screens, launches, streamed


def model_cpu64(models):
    """A SIMCA model on the CPU, its float leaves in float64."""
    def conv(t):
        t = t.detach().cpu()
        return t.double() if t.is_floating_point() else t

    return SIMCAModel(*(LimitResult(*(conv(a) for a in v))
                        if isinstance(v, LimitResult) else conv(v)
                        for v in models))


def serving_vs_cpu_f64(dev, models, scorers, cal64, labels, x):
    """Phase 15: the card's f32 and int8 screens of 4,096 spectra against
    the port's CPU in float64. The CPU f64 fit of the same data (the card's
    test matrix): limits to 1e-3, accepts >= 99.9 %. The CPU f64 scorer of
    the card's own models (its noise-bulk loadings are the card's, so T^2
    of off-class spectra is comparable), with the same center, so that the
    int8 chunks are the same (xq, xs, x2): statistics to 1e-4 of scale,
    accepts >= 99.9 %."""
    omega = default_omega(LENGTH, K + 10, torch.float32, dev)
    ref = fit_classes(cal64, labels, list(range(N_CLASSES)), K, device="cpu",
                      solver="rsvd", omega=omega.double().cpu())
    lims = {"t2_limit": (models.t2_res.limit, ref.t2_res.limit),
            "q_limit": (models.q_res.limit, ref.q_res.limit),
            "d_limit": (models.d_limit, ref.d_limit)}
    line = {"phase": "serving_vs_cpu_f64", "spectra": SRV_N_CPU,
            "limit_rel_err": {k: ((a.double().cpu() - b).abs() / b.abs()
                                  ).max().item() for k, (a, b) in lims.items()}}
    center = scorers["f32"].center
    x_cpu = x[::x.shape[0] // SRV_N_CPU][:SRV_N_CPU]    # every class, off-class
    same = model_cpu64(models)
    for mode, dt in (("f32", None), ("int8", torch.int8)):
        got, want, fit64 = (SIMCAScorer(m, chunk_size=SRV_N_CPU, store_dtype=dt,
                                        center=center).score(x_cpu)
                            for m in (models, same, ref))
        line[mode] = {"stats_rel_err": stats_rel_err(got, want),
                      "accept_agreement": agreement(got, want)[0],
                      "accept_agreement_f64_fit": agreement(got, fit64)[0]}
    print(json.dumps(line), flush=True)
    for k, e in line["limit_rel_err"].items():
        check(e <= 1e-3, f"serving {k} differs from the CPU f64 fit by {e}")
    for mode in ("f32", "int8"):
        for k, e in line[mode]["stats_rel_err"].items():
            check(e <= 1e-4, f"{mode} screen: {k} differs from CPU f64 by {e}")
        for k in ("accept_agreement", "accept_agreement_f64_fit"):
            check(line[mode][k] >= 0.999,
                  f"{mode} screen: {k} {line[mode][k]} < 0.999")


def kernel_timing(fn, plain, inputs, bound, library=None, plain_reps=10):
    """Device ms of ``fn``, its plain twin and a library call over rotating
    ``inputs`` (each call reads its input from device memory, not L2),
    one call's ms with its wrapper, and the bound: a record's numbers."""
    nbytes, ops, rate_bytes, rate_ops = bound
    bytes_ms, ops_ms = 1e3 * nbytes / rate_bytes, 1e3 * ops / rate_ops
    return {"ms": int8_probe.device_ms(fn, inputs),
            "call_ms": median_ms(lambda: fn(inputs[0]), 3, 21),
            "plain_ms": int8_probe.device_ms(plain, inputs, plain_reps),
            "library_ms": (None if library is None
                           else int8_probe.device_ms(library, inputs)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def int8_kernel_timings(dev, gen, bw, int8_rate, xq, wq):
    """K7 and K8 at the probe's tiles and K8 at the scoring shape, each
    beside its bound, twin and library call: {name: timing record}."""
    out = {}
    inputs = int8_probe.rotated(xq)
    n, lp = xq.shape
    w = wq.T.contiguous()                      # K8 takes (M, L)
    for tile in PROBE_TILES:
        read = kernel_timing(
            lambda a, t=tile: kernels.int8_tile_sum(a, t),
            lambda a, t=tile: kernels.int8_tile_sum_plain(a, t), inputs,
            (n * lp + 4 * (n // tile), n * lp, bw, int8_rate),
            library=lambda a, t=tile: kernels.int8_tile_sum_plain(a, t))
        gemm = kernel_timing(
            lambda a, t=tile: kernels.int8_gemm_s32(a, w, t),
            lambda a, t=tile: kernels.int8_gemm_s32_plain(a, w, t), inputs,
            (n * lp + lp * 128 + 4 * (n // tile) * 128, 2 * n * lp * 128, bw,
             int8_rate),
            library=lambda a: torch._int_mm(a, wq), plain_reps=3)
        out[f"k7 t={tile}"], out[f"k8 t={tile}"] = read, gemm
    del inputs
    # K8 at the scoring shape (one chunk against 2 (C k + C) columns), and
    # torch._int_mm on copies zero-padded to K 504 and N 72 (its rules)
    m = 2 * (N_CLASSES * K + N_CLASSES)
    w = torch.randint(-127, 128, (m, LENGTH), dtype=torch.int8,
                      generator=gen).to(dev)
    chunks = [torch.randint(-127, 128, (SRV_CHUNK, LENGTH), dtype=torch.int8,
                            generator=gen).to(dev) for _ in range(5)]
    pad_k, pad_n = -(-LENGTH // 8) * 8, -(-m // 8) * 8
    w_pad = F.pad(w, (0, pad_k - LENGTH, 0, pad_n - m)).T.contiguous()
    padded = {id(c): F.pad(c, (0, pad_k - LENGTH)) for c in chunks}
    out["k8 store"] = kernel_timing(
        lambda a: kernels.int8_gemm_s32(a, w),
        lambda a: kernels.int8_gemm_s32_plain(a, w), chunks,
        (SRV_CHUNK * LENGTH + m * LENGTH + 4 * SRV_CHUNK * m,
         2 * SRV_CHUNK * LENGTH * m, bw, int8_rate),
        library=lambda a: torch._int_mm(padded[id(a)], w_pad), plain_reps=3)
    del chunks, padded
    return out


def serving_timings(dev, card, rates, models, scorers, x, counts, xq, wq,
                    cal32, labels, gen, decisions):
    """Phase 16: screens (numpy in, numpy out) and their split, the
    streaming fit, the bf16 VAE twin's screens, and K7, K8 and bf16 K1
    beside their bounds, twins and library calls. Returns {kernel: timing
    record}."""
    bw, f32_rate, int8_rate = rates
    line = {"phase": "serving_timings", "card": card, "spectra": x.shape[0],
            "chunk": SRV_CHUNK}
    for mode, scorer in scorers.items():
        xin = counts if mode == "raw-u16" else x
        ms = median_ms(lambda: scorer.score(xin), 1, 3)
        prepared = scorer.prepare(xin)
        line[mode] = {
            "simca_screen_ms": ms, "spectra_per_s": x.shape[0] / (ms / 1e3),
            "prepare_ms": median_ms(lambda: scorer.prepare(xin), 1, 3),
            "score_prepared_ms": median_ms(
                lambda: scorer.score_prepared(prepared), 1, 3),
            "shipped_mb": sum(a.numel() * a.element_size()
                              for args, _ in prepared for a in args) / 1e6}
        del prepared
    classes = list(range(N_CLASSES))

    def ingest():
        moms = streaming.moments_init_classes(N_CLASSES, LENGTH)
        for i in range(0, len(labels), SRV_BATCH):
            moms = streaming.moments_update_classes(
                moms, cal32[i:i + SRV_BATCH], labels[i:i + SRV_BATCH], classes)
        return moms

    moms = ingest()
    line["stream_ingest_ms"] = median_ms(ingest, 1, 3)
    line["stream_fit_ms"] = median_ms(lambda: streaming.fit_classes_moments(
        moms, K, solver="rsvd"), 1, 3)
    model, bundle, vs, x_test, _ = decisions
    for variant in ("d2", "vaesimca"):
        twin = VAEScorer(model, bundle, variant=variant, loss_type="cosine",
                         chunk_size=DEC_CHUNK, compute_dtype=torch.bfloat16,
                         vaesimca_model=vs if variant == "vaesimca" else None)
        line[f"vae_bf16_{variant}_screen_ms"] = median_ms(
            lambda: twin.score(x_test), 1, 3)
    print(json.dumps(line), flush=True)

    out = int8_kernel_timings(dev, gen, bw, int8_rate, xq, wq)
    # bf16 K1 at the serving shape: one chunk of bf16 residuals
    center = torch.as_tensor(scorers["f32"].center, device=dev)
    means = (models.mean - center).contiguous()
    rest = (means, models.components.contiguous(), models.invcovT.contiguous())
    step = (x.shape[0] - SRV_CHUNK) // 2
    xs = [(torch.as_tensor(x[i * step:][:SRV_CHUNK], device=dev)
           - center).to(torch.bfloat16) for i in range(3)]
    c, k, length = models.components.shape
    out["k1 bf16"] = kernel_timing(
        lambda a: kernels.t2q_scores_multiclass(a, *rest),
        lambda a: kernels.t2q_scores_multiclass_plain(a, *rest), xs,
        (*k1_work(SRV_CHUNK, length, c, k, 2), bw, f32_rate),
        library=lambda a: library_scores(a.float(), *rest))
    # f32 K1 on the same chunks widened, for the bf16 instantiation's
    # comparison at one shape
    x32 = [a.float() for a in xs]
    f32_chunk = {"ms": int8_probe.device_ms(
        lambda a: kernels.t2q_scores_multiclass(a, *rest), x32)}
    print(json.dumps({"phase": "serving_kernel_timings", "card": card,
                      **out, "k1 f32 at the serving shape": f32_chunk}),
          flush=True)
    for key, rec in out.items():
        check(all(math.isfinite(rec[f]) for f in ("ms", "call_ms",
                                                  "plain_ms", "library_ms")),
              f"{key}: a timing is not finite")
    return out


def serving_phases(dev, card, rates, decisions):
    """Phases 13-16, the serving slice; returns the records of K7, K8 and
    bf16 K1."""
    gen = torch.Generator().manual_seed(13)
    cals, _ = make_data()
    cal64 = cals.reshape(-1, LENGTH)
    cal32 = cal64.astype(np.float32)
    labels = np.repeat(np.arange(N_CLASSES), N_CAL)
    x64 = serving_data()
    x, counts = x64.astype(np.float32), camera_counts(x64)
    del x64
    models = fit_classes(cal32, labels, list(range(N_CLASSES)), K,
                         solver="rsvd")
    xp_cal = prep_raw(torch.as_tensor(camera_counts(cal64), device=dev)
                      .to(torch.float32))
    raw_models = fit_classes(xp_cal, labels, list(range(N_CLASSES)), K,
                             solver="rsvd")
    n, lp, _ = int8_probe.HEADLINE
    xq, wq = int8_probe.make_inputs(n, lp, dev)
    w = wq.T.contiguous()

    # 13. K7, K8 and bf16 K1 against their plain twins
    int8_err = int8_vs_plain(xq, w, gen, dev)
    center = torch.as_tensor(np.mean(models.mean.cpu().numpy(), axis=0),
                             device=dev)
    centered = models._replace(mean=models.mean - center)
    bf16_err = compare_kernel(
        f"bf16 serving N={SRV_CHUNK} L={LENGTH} C=3 k={K}",
        (torch.as_tensor(x[:SRV_CHUNK], device=dev) - center).to(
            torch.bfloat16), centered)
    bf16_err = max(bf16_err, compare_kernel(
        "bf16 ragged N=300 L=203 C=2 k=40",
        torch.randn(300, 203, generator=gen).to(dev, torch.bfloat16),
        _Scorer(2, 40, 203, gen, dev)))

    # 14. the serving path as a user calls it, 15. against CPU f64
    scorers, _, launches, _ = serving_main_path(
        dev, models, raw_models, x, counts, xq, w, cal32, labels, decisions)
    serving_vs_cpu_f64(dev, models, scorers, cal64, labels, x)

    # 16. timings
    t = serving_timings(dev, card, rates, models, scorers, x, counts, xq, wq,
                        cal32, labels, gen, decisions)

    def record(name, key, launch, err, source, replaces):
        rec = t[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launch, "max_abs_err": err,
                **{f: rec[f] for f in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}}

    return [
        record("int8_tile_sum", f"k7 t={PROBE_TILES[0]}",
               launches["probe"]["k7"], int8_err,
               "ocm_tpu_torch/csrc/int8.cu", "scripts/probe_pallas_int8.py:70"),
        record("int8_gemm_s32", "k8 store", launches["int8"]["k8"], int8_err,
               "ocm_tpu_torch/csrc/int8.cu", "scripts/probe_pallas_int8.py:84"),
        record("t2q_scores_multiclass_bf16", "k1 bf16",
               launches["bf16"]["k1_bf16"], bf16_err,
               "ocm_tpu_torch/csrc/t2q_scores.cu",
               "ocm_tpu/ops/kernels.py:45")]


def k1_kernel_timings(dev, gen, bw, f32_rate):
    """K1 at the main path's shape (98,304 x 500, C 3, k 10) and at one
    serving chunk (65,536), f32 and bf16 x, each over 3 rotating inputs
    beside its bound and the library formulation: {name: timing record}."""
    models = _Scorer(N_CLASSES, K, LENGTH, gen, dev)
    rest = (models.mean, models.components.contiguous(),
            models.invcovT.contiguous())
    out = {}
    for n, dtype in ((N_SCORE, torch.float32), (SRV_CHUNK, torch.float32),
                     (SRV_CHUNK, torch.bfloat16)):
        xs = [(torch.randn(n, LENGTH, generator=gen) + 5.0).to(dev, dtype)
              for _ in range(3)]
        size = torch.finfo(dtype).bits // 8
        out[f"k1 {'bf16' if size == 2 else 'f32'} n={n}"] = kernel_timing(
            lambda a: kernels.t2q_scores_multiclass(a, *rest),
            lambda a: kernels.t2q_scores_multiclass_plain(a, *rest), xs,
            (*k1_work(n, LENGTH, N_CLASSES, K, size), bw, f32_rate),
            library=lambda a: library_scores(a.float(), *rest), plain_reps=3)
        del xs
    return out


def kernel_times(dev, card, name):
    """``--kernel-times``: only the timings of K1 and bf16 K1
    (``k1_kernel_timings``), K2/K3 (the train step's six shapes, rotating
    past the L2 and L2-warm), K7/K8 (the probe's tiles, the scoring
    shape), K4, K6's backward and the ``fc_logvar`` Linear then K4 at the
    train batch (``time_reparam_train``), K5 at (512, 16) and (65,536, 16)
    (``time_sample``), K9 at the nuts screens' activations
    (``time_bn_eval``, where the package has it) and the launch floor,
    through the package beside this file.  A copy of this script
    in another tree of the repo times that tree's kernels the same way, so
    two versions can be timed in turns within one chip call."""
    bw, f32_rate, int8_rate = peaks(name)
    _build.library()
    k1_t = k1_kernel_timings(dev, torch.Generator().manual_seed(1), bw,
                             f32_rate)
    bn_t, _ = time_bn(TRAIN_BN_SHAPES, torch.Generator().manual_seed(0), dev,
                      bw, f32_rate)
    n, lp, _ = int8_probe.HEADLINE
    xq, wq = int8_probe.make_inputs(n, lp, dev)
    int8_t = int8_kernel_timings(dev, torch.Generator().manual_seed(13), bw,
                                 int8_rate, xq, wq)
    gen = torch.Generator().manual_seed(7)
    reparam_t = time_reparam_train(dev, gen, bw, f32_rate)
    k5_t = {n: time_sample((n, VAE_KW["latent_dim"]), gen, dev, bw, f32_rate)
            for n in (DEC_N_CAL, DEC_N_TEST)}
    k9_t = (time_bn_eval(dev, bw, f32_rate) if hasattr(bn, "bn_act_eval")
            else None)
    print(json.dumps({"phase": "kernel_times", "card": card,
                      "package": os.path.dirname(os.path.dirname(
                          os.path.abspath(bn.__file__))),
                      "k1": k1_t, "bn": bn_t, "int8": int8_t,
                      "reparam": reparam_t, "k5": k5_t, "k9": k9_t}),
          flush=True)


# --- the CV slice ------------------------------------------------------------

# bench_all.py:71-79's CV workload: 600 target (class 0) and 300 other
# spectra of 500 channels, LVs 2-12, 5 folds
CV_N0, CV_N1, CV_LVS, CV_FOLDS = 600, 300, list(range(2, 13)), 5
# the unequal-class fits: make_data(seed=0)'s classes cut to these counts
UNEQUAL = (700, 520, 340)


def cv_data():
    """``bench_all.py:bench_cvsimca``'s spectra and labels (f32)."""
    rng = np.random.default_rng(1)
    t = np.linspace(0, 1, LENGTH)
    x0 = rng.normal(1, .08, (CV_N0, 1)) * np.sin(2 * np.pi * 3 * t) + \
        rng.normal(0, .02, (CV_N0, LENGTH))
    x1 = rng.normal(1, .08, (CV_N1, 1)) * np.sin(2 * np.pi * 4 * t) + \
        rng.normal(0, .02, (CV_N1, LENGTH))
    return (np.concatenate([x0, x1]).astype(np.float32),
            np.concatenate([np.zeros(CV_N0), np.ones(CV_N1)]))


def clocked_call(run):
    """One call of ``run`` on the host clock, synchronized at both ends:
    ``out``, ``ms``, the K1 ``launches`` it made (the count set to 0 just
    before, read just after), the ms spent in the batched decomposition
    (``fold_decomposition``) and the limit engines (``lv_limits``), each
    bracketed by a synchronize, and the last ``sweep`` (LVSweep, pooled)
    that ``cv._sweep`` returned and the last default test matrix
    (``omega``) drawn, None where the call made none."""
    parts = {"fold_decomposition": 0.0, "lv_limits": 0.0}
    seen = {"sweep": None, "omega": None}
    real = {name: getattr(cv, name) for name in (*parts, "_sweep")}
    real_omega = linalg.default_omega

    def clocked(name):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kwargs)
            torch.cuda.synchronize()
            parts[name] += 1e3 * (time.perf_counter() - t0)
            return out
        return wrapper

    def recorded(key, fn):
        def wrapper(*args, **kwargs):
            seen[key] = fn(*args, **kwargs)
            return seen[key]
        return wrapper

    try:
        for name in parts:
            setattr(cv, name, clocked(name))
        cv._sweep = recorded("sweep", real["_sweep"])
        linalg.default_omega = recorded("omega", real_omega)
        torch.cuda.synchronize()
        kernels.t2q_scores_multiclass.launches = 0
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = kernels.t2q_scores_multiclass.launches
    finally:
        for name, fn in real.items():
            setattr(cv, name, fn)
        linalg.default_omega = real_omega
    return {"out": out, "ms": ms, "launches": launches, "parts": parts,
            **seen}


def cv_vs_cpu_f64(x32, y, solver, call, sweep_kw):
    """The card's f32 sweep, as ``call`` (``clocked_call`` of the path's
    ``cv_simca_sweep``) caught it, against the port's CPU f64 sweep of the
    same data and arguments, rsvd with the card call's own test matrix:
    per-cell limits to 1e-3, per-LV spec and sens within 2 samples' share
    of their denominators, pooled predictions >= 99.9 % equal.  The caught
    pooled results must be those the call returned."""
    card, card_pool = call["sweep"]
    for key in ("pred", "spec", "sens"):
        check(np.array_equal(card_pool[key][0].cpu().numpy(),
                             call["out"][key]),
              f"cv {solver}: the caught sweep's {key} is not the returned one")
    check((call["omega"] is None) == (solver != "rsvd"),
          f"cv {solver}: test matrix drawn: {call['omega'] is not None}")
    omega = None if call["omega"] is None else call["omega"].double().cpu()
    cpu, cpu_pool = clocked_call(lambda: cv.cv_simca_sweep(
        x32.astype(np.float64), y, 0, CV_LVS, device="cpu", omega=omega,
        **sweep_kw))["sweep"]
    rel = {}
    for key, a, b in (("t2_limit", card.t2_res.limit, cpu.t2_res.limit),
                      ("q_limit", card.q_res.limit, cpu.q_res.limit),
                      ("d_limit", card.d_limit, cpu.d_limit)):
        check_limits(f"cv {solver} sweep", {key: a})
        rel[key] = ((a.double().cpu() - b).abs() / b.abs()).max().item()
    diff = {k: (card_pool[k].double().cpu() - cpu_pool[k]).abs().max().item()
            for k in ("spec", "sens")}
    agree = (card_pool["pred"].cpu() == cpu_pool["pred"]).float().mean().item()
    line = {"phase": "cv_vs_cpu_f64", "solver": solver,
            "cell_limit_rel_err": rel, "max_abs_diff_pct": diff,
            "pred_agreement": agree}
    print(json.dumps(line), flush=True)
    for key, e in rel.items():
        check(e <= 1e-3, f"cv {solver}: {key} differs from CPU f64 by {e}")
    # one fold's spec moves 100/300 a sample; the pooled sens 100/600
    for key, denom in (("spec", CV_N1), ("sens", CV_N0)):
        check(diff[key] <= 2 * 100.0 / denom,
              f"cv {solver}: {key} differs from CPU f64 by {diff[key]}")
    check(agree >= 0.999, f"cv {solver}: pred agreement {agree} < 0.999")


def estimator_kernels(label, est, x, predictions):
    """K1 against its plain twin on the models ``est.predict`` scored (the
    stacked models at one k, else each class's), and the predictions it
    returned for x against the plain twin's decisions."""
    models = [est._dd_limits(est._model[c]) for c in est.model_class]
    accept = torch.as_tensor(predictions.T > 0.5, device=x.device)
    ks = est._n_components_per_class
    if len(models) > 1 and len(set(ks)) == 1:
        compare_kernel(f"{label} C={len(models)} k={ks[0]}", x,
                       stack_models(models), est.type, accept)
        return
    for i, m in enumerate(models):
        compare_kernel(f"{label} class {est.model_class[i]} k={ks[i]}", x,
                       stack_models([m]), est.type, accept[i:i + 1])


def persistence_round_trip(dev, simca_models, decisions, x):
    """Each of the four model kinds saved to a temporary directory and
    loaded back onto the card: a reloaded SIMCAModel scores bit-equal, a
    reloaded SpectraMoments refits to equal limits, a reloaded bundle and
    VAE-SIMCA state hold bit-equal leaves."""
    model, bundle, vs, _, _ = decisions
    moms = streaming.moments_update_classes(
        streaming.moments_init_classes(3, LENGTH, device=dev),
        x[:3 * 300], np.repeat([0, 1, 2], 300), [0, 1, 2])
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.msgpack")
                 for k in ("simca", "moments", "bundle", "vaesimca")}
        save_simca_model(paths["simca"], simca_models)
        streaming.save_moments(paths["moments"], moms)
        vae_bundle.save_bundle(paths["bundle"], bundle, model)
        vaesimca.save_vaesimca_model(paths["vaesimca"], vs)
        sizes = {k: os.path.getsize(p) for k, p in paths.items()}
        simca_back = load_simca_model(paths["simca"], device=dev)
        moms_back = streaming.load_moments(paths["moments"], device=dev)
        bundle_back = vae_bundle.load_bundle(paths["bundle"], model,
                                             device=dev)
        vs_back = vaesimca.load_vaesimca_model(paths["vaesimca"], device=dev)
    scores = [predict_classes(m, x[:SRV_CHUNK])
              for m in (simca_models, simca_back)]
    scores_equal = all(torch.equal(a, b) for a, b in zip(*scores))
    fits = [streaming.fit_classes_moments(m, K, solver="eigh")
            for m in (moms, moms_back)]
    refit_equal = all(torch.equal(a, b) for a, b in zip(
        (fits[0].t2_res.limit, fits[0].q_res.limit, fits[0].d_limit),
        (fits[1].t2_res.limit, fits[1].q_res.limit, fits[1].d_limit)))
    # every leaf the file holds: the reference's format has no BatchNorm
    # counter (num_batches_tracked loads as 0; the eval forward reads none)
    leaves = [(k, v) for k, v in bundle.state_dict.items()
              if not k.endswith("num_batches_tracked")] + [
        (f, getattr(bundle, f)) for f in bundle._fields[1:]]
    bundle_equal = all(torch.equal(v, bundle_back.state_dict[k]
                                   if k in bundle.state_dict
                                   else getattr(bundle_back, k))
                       for k, v in leaves)
    vs_equal = all(torch.equal(getattr(vs, f), getattr(vs_back, f))
                   for f in vs._fields)
    line = {"phase": "persistence", "bytes": sizes,
            "simca_scores_bit_equal": scores_equal,
            "moments_refit_equal": refit_equal,
            "bundle_leaves_equal": bundle_equal,
            "vaesimca_leaves_equal": vs_equal,
            "on_device": all(str(a.device).startswith("cuda") for a in (
                simca_back.mean, moms_back.scatter, bundle_back.spec_mean,
                vs_back.d_limit))}
    print(json.dumps(line), flush=True)
    for key, ok in line.items():
        if key not in ("phase", "bytes"):
            check(ok, f"persistence: {key} is false")


def cv_phases(dev, card, decisions):
    """Phase 17, the CV slice: CV-SIMCA and the masked fits at full width,
    as a user calls them; returns the K1 launches they made."""
    t_phase = time.perf_counter()
    x32, y = cv_data()
    x_dev = torch.as_tensor(x32, device=dev)
    cals, xs = make_data()
    x_u = np.concatenate([cals[c, :n] for c, n in enumerate(UNEQUAL)]
                         ).astype(np.float32)
    y_u = np.repeat(np.arange(N_CLASSES), UNEQUAL)
    xs32 = torch.as_tensor(xs.astype(np.float32), device=dev)
    sweep_kw = {"rsvd": dict(solver="rsvd"), "eigh": dict(side="cov"),
                "gram": dict(side="gram")}
    for kw in sweep_kw.values():
        kw["n_splits"] = CV_FOLDS
    runs = {
        **{key: (lambda kw=kw: cv.cv_simca_sweep(x32, y, 0, CV_LVS, **kw))
           for key, kw in sweep_kw.items()},
        "multiclass": lambda: cv.cv_simca_sweep_multiclass(
            x32, y, [0, 1], CV_LVS, n_splits=CV_FOLDS),
        "grid": lambda: cv.cross_validate_simca_grid(
            SIMCA(model_class=0, type="alt", t2lim="Fdist",
                  qlim="jm", verbose=False, solver="rsvd"),
            x32, y, cv.ClasswiseKFoldWithExternalVal(CV_FOLDS, cls_label=0),
            LV_min=min(CV_LVS), LV_max=max(CV_LVS),
            param_grid={"type": ["alt", "sim"]}, print_summary=False),
        "masked_rsvd": lambda: fit_classes(x_u, y_u, [0, 1, 2], K,
                                           solver="rsvd"),
        "masked_eigh": lambda: fit_classes(x_u, y_u, [0, 1, 2], K,
                                           solver="eigh"),
    }
    # the path, as a user calls it (numpy in), K1 counted call by call.
    # The first call (the rsvd sweep) is the phase's warm-up: it runs every
    # limit engine, which holds over 97 % of each call's time; every other
    # path call is the first of its run's 2 timed calls
    calls = {key: clocked_call(run) for key, run in runs.items()}
    timed = {key: [] if key == "rsvd" else [call]
             for key, call in calls.items()}
    out = {key: call["out"] for key, call in calls.items()}
    launches = {key: call["launches"] for key, call in calls.items()}
    best = out["grid"]["best_estimator"]
    call = clocked_call(lambda: best.predict(x32))
    pred_best, launches["grid_best_predict"] = call["out"], call["launches"]
    for key in ("masked_rsvd", "masked_eigh"):
        call = clocked_call(lambda: predict_classes(out[key], xs32)[0])
        out[f"{key}_accept"] = call["out"]
        launches[f"{key}_predict"] = call["launches"]
    ests = {}
    for ncomp in (K, [8, 10, 12]):
        ests[str(ncomp)] = est = SIMCA(n_components=ncomp,
                                       model_class=[0, 1, 2],
                                       verbose=False).fit(x_u, y_u)
        call = clocked_call(lambda: est.predict(xs32))
        out[f"simca_{ncomp}"] = call["out"]
        launches[f"simca_predict_{ncomp}"] = call["launches"]
    want = {key: 0 for key in runs}
    want.update({"grid_best_predict": 1, "masked_rsvd_predict": 1,
                 "masked_eigh_predict": 1, f"simca_predict_{K}": 1,
                 "simca_predict_[8, 10, 12]": 3})
    check(launches == want, f"phase 17 K1 launches {launches} != {want}")
    # K1 against its plain twin at every plan and model set the path
    # scored, and the path's decisions against the twin's
    for key in ("masked_rsvd", "masked_eigh"):
        compare_kernel(f"{key} N={N_SCORE} C=3 k={K}", xs32, out[key],
                       path_accept=out[f"{key}_accept"])
    for ncomp, est in ests.items():
        estimator_kernels(f"SIMCA({ncomp}) N={N_SCORE}", est, xs32,
                          out[f"simca_{ncomp}"])
    estimator_kernels(f"grid best N={CV_N0 + CV_N1}", best, x_dev, pred_best)

    for key, sweep in out.items():
        if key in ("rsvd", "eigh", "gram", "multiclass"):
            n = len(CV_LVS)
            check(all(np.isfinite(sweep[k]).all() for k in ("sens", "spec")),
                  f"cv {key}: non-finite metrics")
            check(sweep["pred"].shape[-2:] == (n, CV_N0 + CV_N1),
                  f"cv {key}: pred shape {sweep['pred'].shape}")
    gram_agree = float(np.mean(out["eigh"]["pred"] == out["gram"]["pred"]))
    masked_agree = (out["masked_rsvd_accept"] == out["masked_eigh_accept"]
                    ).float().mean().item()
    for key in ("masked_rsvd", "masked_eigh"):
        m = out[key]
        check_limits(f"{key} fit", {"t2_limit": m.t2_res.limit,
                                    "q_limit": m.q_res.limit,
                                    "d_limit": m.d_limit})
        check(m.n_samples.tolist() == list(UNEQUAL),
              f"{key}: counts {m.n_samples.tolist()}")
    # masks all on: the masked fit of three equal classes is fit_simca's
    cals_dev = torch.as_tensor(cals.astype(np.float32), device=dev)
    dense = fit_simca(cals_dev, K)
    masked = fit_simca_masked(
        cals_dev, torch.ones(cals.shape[:2], device=dev), K)
    equal_rel = {key: ((a - b).abs() / b.abs()).max().item() for key, a, b in (
        ("t2_limit", masked.t2_res.limit, dense.t2_res.limit),
        ("q_limit", masked.q_res.limit, dense.q_res.limit),
        ("d_limit", masked.d_limit, dense.d_limit))}
    grid = out["grid"]
    print(json.dumps({
        "phase": "cv_main_path", "k1_launches": launches,
        "rsvd_eff": out["rsvd"]["eff"].tolist(),
        "eigh_eff": out["eigh"]["eff"].tolist(),
        "multiclass_eff": out["multiclass"]["eff"].tolist(),
        "grid_best": {"LV": grid["best_LV"], "params": grid["best_params"],
                      "score": grid["best_score"]},
        "grid_best_accept_rate": pred_best.mean(0).tolist(),
        "cov_vs_gram_pred_agreement": gram_agree,
        "masked_rsvd_vs_eigh_accept_agreement": masked_agree,
        "masked_vs_fit_simca_rel_err": equal_rel,
        "masked_counts": list(UNEQUAL)}), flush=True)
    check(gram_agree >= 0.999, f"cov vs gram pred agreement {gram_agree}")
    check(masked_agree >= 0.999,
          f"masked rsvd vs eigh accept agreement {masked_agree}")
    for key, e in equal_rel.items():
        check(e <= 1e-3, f"masked fit of equal classes: {key} off by {e}")

    # the card (f32) against the port's CPU f64, from the path's own calls
    for solver in ("rsvd", "eigh"):
        cv_vs_cpu_f64(x32, y, solver, calls[solver], sweep_kw[solver])
    persistence_round_trip(dev, out["masked_rsvd"], decisions, xs32)

    # timings: the faster of 2 timed calls a run, each with its split (3
    # until phase 19 came: cut so that the whole run keeps its time)
    del calls, out
    for key, run in runs.items():
        while len(timed[key]) < 2:
            timed[key].append(clocked_call(run))
    ms, split = {}, {}
    for key, reps in timed.items():
        mid = min(reps, key=lambda c: c["ms"])
        ms[key] = mid["ms"]
        if key in sweep_kw or key in ("multiclass", "grid"):
            decomp = mid["parts"]["fold_decomposition"]
            limits = mid["parts"]["lv_limits"]
            split[key] = {"decomposition_ms": decomp,
                          "limit_engines_ms": limits,
                          "rest_ms": ms[key] - decomp - limits,
                          "limit_engines_share": limits / ms[key]}
    n_fits = len(CV_LVS) * CV_FOLDS
    line = {"phase": "cv_timings", "card": card,
            **{f"cv_sweep_ms_{k}": ms[k] for k in sweep_kw},
            **{f"cv_fits_per_s_{k}": 1e3 * n_fits / ms[k] for k in sweep_kw},
            "cv_multiclass_ms": ms["multiclass"], "cv_grid_ms": ms["grid"],
            "masked_fit_ms_rsvd": ms["masked_rsvd"],
            "masked_fit_ms_eigh": ms["masked_eigh"], "sweep_split": split,
            "phase_s": time.perf_counter() - t_phase}
    print(json.dumps(line), flush=True)
    check(all(math.isfinite(v) for v in ms.values()), "a CV timing is "
          "not finite")
    return sum(launches.values())


# --- the data layer (phase 18) ------------------------------------------------

# examples/hsi_pipeline.py --cube-scale: 512 x 512 x 288 uint16 cubes, 2 a
# class x 3 classes + 1 unknown (1,835,008 pixel spectra), 12 disks of radius
# 32-73 px a cube, counts at 1e4 a unit of reflectance, foreground at half
# of it, objects of >= 8 px, 70 % of a class's objects (at most 20,000 of
# their pixels) to calibrate k 10, screened in chunks of 65,536
HSI_SIZE, HSI_L, HSI_CUBES, HSI_CLASSES = 512, 288, 2, 3
HSI_RADIUS = (max(3, HSI_SIZE // 16), max(6, HSI_SIZE // 7))
HSI_SCALE, HSI_MIN_PX, HSI_CAL_MAX, HSI_K = 1e4, 8, 20000, 10
HSI_CHUNK = 65536
HSI_MODES = ("raw-u16", "f32", "bf16", "int8")
# examples/simca_nuts.py's SIMCA; examples/cheese_eda_plsda.py's sweep
NUTS_K, PLS_MAX_K, PLS_FOLDS = 12, 25, 5


def hsi_cubes():
    """The example's uint16 camera cubes: (class, cube) for 2 cubes of each
    class (seeds 97 c + i) and one of an unknown class (seed 9999)."""
    def counts_cube(seed, nut_idx):
        cube = synthetic.nut_cube(seed=seed, nut_idx=nut_idx, height=HSI_SIZE,
                                  width=HSI_SIZE, length=HSI_L, n_objects=12,
                                  radius_range=HSI_RADIUS)
        return np.clip(np.round(cube * HSI_SCALE), 0, 65535).astype(np.uint16)

    keys = [(97 * c + i, c) for c in range(HSI_CLASSES)
            for i in range(HSI_CUBES)] + [(9999, HSI_CLASSES)]
    # numpy's generators and array passes release the GIL: one thread a cube
    with ThreadPoolExecutor(len(keys)) as ex:
        return list(zip((c for _, c in keys),
                        ex.map(lambda key: counts_cube(*key), keys)))


def segment_cubes(cubes):
    """Native segmentation of every class cube into the object store
    (class -> images' object lists), each cube timed; the first cube also
    by the scipy route (``io.extract_objects``), which must give the same
    objects, pixel counts and centroids and bit-equal spectra."""
    store, native_ms = {}, []
    thr = 0.5 * HSI_SCALE
    for cls, cube in cubes[:-1]:
        t0 = time.perf_counter()
        objs = native.extract_objects_native(cube, thr, min_pixels=HSI_MIN_PX)
        native_ms.append(1e3 * (time.perf_counter() - t0))
        store.setdefault(str(cls), []).append(objs)
    from scipy import ndimage  # noqa: F401  (its import is not timed)

    t0 = time.perf_counter()
    ref = data_io.extract_objects(cubes[0][1], thr, min_pixels=HSI_MIN_PX)
    scipy_ms = 1e3 * (time.perf_counter() - t0)
    got = store["0"][0]
    same = len(got) == len(ref) and all(
        a["n_pixels"] == b["n_pixels"] and a["obj_idx"] == b["obj_idx"]
        and a["centroid"] == b["centroid"]
        and np.array_equal(a["spectral_data"], b["spectral_data"])
        for a, b in zip(got, ref))
    check(same, "native segmentation differs from the scipy route")
    return store, {"segment_ms_native": native_ms,
                   "segment_ms_scipy": scipy_ms,
                   "objects_per_cube": [len(o) for imgs in store.values()
                                        for o in imgs],
                   "object_pixels": sum(o["n_pixels"] for imgs in
                                        store.values() for img in imgs
                                        for o in img)}


def hsi_fit(store, dev):
    """The example's object-level calibration split (70 % of each class's
    objects, at most 20,000 of their pixels, ``default_rng(0)``), SNV +
    SavGol on the card and the stacked fit, as a user calls them."""
    rng = np.random.default_rng(0)
    xs, ys = [], []
    for cls in range(HSI_CLASSES):
        objs = [o for img in store[str(cls)] for o in img]
        order = rng.permutation(len(objs))[:max(1, int(0.7 * len(objs)))]
        px = np.concatenate([objs[i]["spectral_data"] for i in order])
        if px.shape[0] > HSI_CAL_MAX:
            px = px[rng.choice(px.shape[0], HSI_CAL_MAX, replace=False)]
        xs.append(px)
        ys.append(np.full(px.shape[0], cls))
    x_cal = prep_raw(torch.as_tensor(np.concatenate(xs), device=dev))
    return fit_classes(x_cal, np.concatenate(ys), list(range(HSI_CLASSES)),
                       HSI_K)


def hsi_scorers(models):
    """The example's four serving modes (examples/hsi_pipeline.py:131-141)."""
    return {"raw-u16": SIMCAScorer(models, chunk_size=HSI_CHUNK,
                                   preprocess_fn=prep_raw),
            "f32": SIMCAScorer(models, chunk_size=HSI_CHUNK),
            "bf16": SIMCAScorer(models, chunk_size=HSI_CHUNK,
                                store_dtype=torch.bfloat16),
            "int8": SIMCAScorer(models, chunk_size=HSI_CHUNK,
                                store_dtype=torch.int8)}


def hsi_screens(scorers, frames, prepped):
    """Every pixel of every cube through each mode: one warm-up chunk, then
    three timed passes; the first is the path's, its launches counted (the
    counts set to 0 just before, read just after). Returns (screens of the
    first pass, launches, ms of each pass)."""
    screens, launches, ms = {}, {}, {}
    for mode, scorer in scorers.items():
        inputs = frames if mode == "raw-u16" else prepped
        scorer.score(inputs[0][:HSI_CHUNK])
        passes = []
        for rep in range(3):
            if rep == 0:
                zero_launch_counts()
            t0 = time.perf_counter()
            outs = [scorer.score(f) for f in inputs]
            passes.append(1e3 * (time.perf_counter() - t0))
            if rep == 0:
                launches[mode] = launch_counts()
                screens[mode] = {k: np.concatenate([o[k] for o in outs])
                                 for k in ("accept", "dred")}
            del outs
        ms[mode] = passes
    return screens, launches, ms


def prep_split(scorer, chunk, reps=5):
    """One chunk through a mode: the scorer's host stage, the copy to the
    card and the device decision + fetch (``score_prepared``), medians of
    ``reps`` on the host clock, each synchronized."""
    def host():
        return scorer.host_chunk(chunk)

    def copy_():
        out = scorer.to_device(staged)
        torch.cuda.synchronize()
        return out

    staged = host()
    prepared = [(copy_(), chunk.shape[0])]
    scorer.score_prepared(prepared)
    times = {}
    for key, fn in (("host_prep_ms", host), ("h2d_ms", copy_),
                    ("decide_fetch_ms",
                     lambda: scorer.score_prepared(prepared))):
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            runs.append(1e3 * (time.perf_counter() - t0))
        times[key] = statistics.median(runs)
    times["shipped_mb"] = sum(t.numel() * t.element_size()
                              for t in staged) / 1e6
    return times


def capture_k8_operands(run):
    """(xq, w) of the first K8 launch that ``run()`` makes through
    ``ops.linalg`` (the int8 scorer's exact operands)."""
    seen, real = [], linalg.int8_gemm_s32

    def recording(xq, w, *args, **kwargs):
        seen.append((xq, w))
        return real(xq, w, *args, **kwargs)

    linalg.int8_gemm_s32 = recording
    try:
        run()
    finally:
        linalg.int8_gemm_s32 = real
    return seen[0]


def k8_vs_plain(label, xq, w):
    """K8's stored product against its twin as integers."""
    got = kernels.int8_gemm_s32(xq, w)
    torch.cuda.synchronize()
    err = (got.long() - kernels.int8_gemm_s32_plain(xq, w).long()
           ).abs().max().item()
    print(json.dumps({"phase": "int8_vs_plain", "cases": [
        {"shape": label, "n": xq.shape[0], "l": xq.shape[1],
         "cols": w.shape[0], "store": True, "k8_max_abs_err": err}]}),
          flush=True)
    check(err == 0, f"K8 at {label}: error {err}")
    return err


def hsi_pipeline(dev, card):
    """Phase 18 A: examples/hsi_pipeline.py --cube-scale on the card (its
    HDF5 store round trip, step 2b, left out: h5py is not on the card's
    machine). Returns (the store, launches by record, errors, timings)."""
    t0 = time.perf_counter()
    cubes = hsi_cubes()
    timings = {"generate_s": time.perf_counter() - t0}
    n_px = sum(c.shape[0] * c.shape[1] for _, c in cubes)
    store, seg = segment_cubes(cubes)
    t0 = time.perf_counter()
    models = hsi_fit(store, dev)
    torch.cuda.synchronize()
    timings["fit_ms"] = 1e3 * (time.perf_counter() - t0)
    check_limits("hsi fit", {"t2_limit": models.t2_res.limit,
                             "q_limit": models.q_res.limit,
                             "d_limit": models.d_limit})
    frames = [cube.reshape(-1, HSI_L) for _, cube in cubes]
    del cubes
    # the non-raw modes' input: SNV + SavGol on the card, fetched once
    t0 = time.perf_counter()
    prepped = [prep_raw(torch.as_tensor(f, device=dev).to(torch.float32))
               .cpu().numpy() for f in frames]
    timings["card_prep_fetch_ms"] = 1e3 * (time.perf_counter() - t0)
    scorers = hsi_scorers(models)
    screens, launches, pass_ms = hsi_screens(scorers, frames, prepped)
    print(json.dumps({"phase": "hsi_launches", "launches": launches}),
          flush=True)
    n_chunks = sum(-(-f.shape[0] // HSI_CHUNK) for f in frames)
    none = {"k1_f32": 0, "k1_bf16": 0, "k7": 0, "k8": 0}
    want = {"raw-u16": {**none, "k1_f32": n_chunks},
            "f32": {**none, "k1_f32": n_chunks},
            "bf16": {**none, "k1_bf16": n_chunks},
            "int8": {**none, "k8": n_chunks}}
    for mode in HSI_MODES:
        check(launches[mode] == want[mode], f"hsi {mode} launches "
              f"{launches[mode]} != {want[mode]}")

    line = {"phase": "hsi_main_path", "cubes": len(frames), "pixels": n_px,
            "chunks_a_pass": n_chunks, **seg}
    for mode in ("raw-u16", "bf16", "int8"):
        agree, dred = agreement(screens[mode], screens["f32"])
        line[f"{mode}_vs_f32"] = {"accept": agree, "dred_of_max": dred}
        floor = 0.999 if mode == "raw-u16" else 0.995
        check(agree >= floor, f"hsi {mode} accepts vs f32 {agree} < {floor}")
        if mode != "raw-u16":
            check(dred <= 3e-2, f"hsi {mode} dred vs f32 {dred} > 3e-2")
    # the int8 scorer's first prepared chunk against the numpy twin's prep
    int8 = scorers["int8"]
    chunk = prepped[0][:HSI_CHUNK]
    got = [t.cpu().numpy() for t in int8.prepare(chunk)[0][0]]
    want8 = native.quantize_rows_int8_plain(chunk, center=int8.center)
    check(all(np.array_equal(g, w) for g, w in zip(got, want8)),
          "int8 prepared chunk differs from the numpy twin's")
    line["int8_prepared_bit_equal_numpy_twin"] = True
    # quality, as the example's step 5: accept rates on the f32 screen
    f32_acc = np.split(screens["f32"]["accept"], len(frames))
    fg = [f.mean(axis=1) >= 0.5 * HSI_SCALE for f in frames]
    rates = {}
    for cls in range(HSI_CLASSES + 1):
        own = [i for i in range(len(frames))
               if (i // HSI_CUBES if i < len(frames) - 1 else HSI_CLASSES)
               == cls]
        acc = np.concatenate([f32_acc[i] for i in own])
        f = np.concatenate([fg[i] for i in own])
        if cls < HSI_CLASSES:
            rates[f"class_{cls}"] = {
                "own": float(acc[f][:, cls].mean()),
                "any": float(acc[f].any(axis=1).mean()),
                "background_any": float(acc[~f].any(axis=1).mean())}
        else:
            rates["unknown_any"] = float(acc[f].any(axis=1).mean())
    line["accept_rates"] = rates
    print(json.dumps(line), flush=True)

    # the kernels at this slice's own plans: L 288, C 3, k 10
    center = torch.as_tensor(scorers["f32"].center, device=dev)
    centered = models._replace(mean=models.mean - center)
    x0 = torch.as_tensor(chunk, device=dev) - center
    errs = {"k1": compare_kernel(f"hsi f32 N={HSI_CHUNK} L={HSI_L} C=3 k=10",
                                 x0, centered),
            "k1_bf16": compare_kernel(
                f"hsi bf16 N={HSI_CHUNK} L={HSI_L} C=3 k=10",
                x0.to(torch.bfloat16), centered)}
    xq, w = capture_k8_operands(lambda: int8.score(chunk))
    errs["k8"] = k8_vs_plain(f"hsi int8 N={HSI_CHUNK} L={HSI_L} C=3 k=10",
                             xq, w)

    # timings: the screens, each mode's split on one chunk, the int8 prep
    timings["hsi_screen_ms"] = {m: statistics.median(v)
                                for m, v in pass_ms.items()}
    timings["hsi_screen_pass_ms"] = pass_ms
    timings["px_per_s"] = {m: n_px / (v / 1e3)
                           for m, v in timings["hsi_screen_ms"].items()}
    timings["chunk_split"] = {
        m: prep_split(s, frames[0][:HSI_CHUNK] if m == "raw-u16" else chunk)
        for m, s in scorers.items()}
    nat, plain = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        native.quantize_rows_int8(chunk, center=int8.center)
        nat.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        native.quantize_rows_int8_plain(chunk, center=int8.center)
        plain.append(1e3 * (time.perf_counter() - t0))
    timings["int8_prep_ms"] = {
        "native": statistics.median(nat), "numpy_twin": statistics.median(plain),
        "threads": native.threads_for(chunk.size),
        "affinity_cpus": len(os.sched_getaffinity(0)),
        "os_cpu_count": os.cpu_count()}
    rec = {"t2q_scores_multiclass": launches["raw-u16"]["k1_f32"]
           + launches["f32"]["k1_f32"],
           "t2q_scores_multiclass_bf16": launches["bf16"]["k1_bf16"],
           "int8_gemm_s32": launches["int8"]["k8"]}
    return store, rec, errs, timings


def nuts_simca(dev, store):
    """Phase 18 B: examples/simca_nuts.py on the pipeline's segmented
    objects (target class 0, outlier removal on): ``object_aware_splits``,
    SNV + SavGol on the card, ``SIMCA(12, 0, 'alt', 'Fdist', 'jm')`` fit
    and one ``predict`` (exactly 1 K1 launch), K1 against its twin, and
    the outlier masks of class 0 on the card (f32) against the port's CPU
    (f64). Returns (K1 launches, timings)."""
    names = [str(c) for c in range(HSI_CLASSES)]
    data = {c: [o for img in store[c] for o in img] for c in names}
    t0 = time.perf_counter()
    res = splits.object_aware_splits(data, names, "0", HSI_L, verbose=False,
                                     device=dev)
    timings = {"split_ms": 1e3 * (time.perf_counter() - t0)}
    x_cal = prep_raw(torch.as_tensor(res.x_cal, device=dev))
    x_test = prep_raw(torch.as_tensor(res.x_test, device=dev))
    est = SIMCA(n_components=NUTS_K, model_class=0, type="alt", t2lim="Fdist",
                qlim="jm", verbose=False).fit(
        x_cal, np.zeros(x_cal.shape[0], dtype=int))
    kernels.t2q_scores_multiclass.launches = 0
    pred = est.predict(x_test, y_true=res.y_test)
    torch.cuda.synchronize()
    launches = kernels.t2q_scores_multiclass.launches
    check(launches == 1, f"nuts SIMCA.predict launched K1 {launches} times")
    estimator_kernels(f"nuts SIMCA N={x_test.shape[0]} L={HSI_L}", est,
                      x_test, pred)

    # class 0's pixels: the outlier mask on the card against CPU f64
    objs = [np.asarray(o["spectral_data"], np.float32) for o in data["0"]]
    x0 = np.vstack(objs)
    obj_ids = np.repeat(np.arange(len(objs)), [len(o) for o in objs])
    n_comp = outliers.effective_n_components(*x0.shape)
    x_dev = prep_raw(torch.as_tensor(x0, device=dev))
    x_cpu = prep_raw(torch.as_tensor(x0, dtype=torch.float64))
    omega = default_omega(HSI_L, min(n_comp + 10, HSI_L), torch.float32, dev)
    masks = {}
    for solver in ("svd", "rsvd"):
        om = omega if solver == "rsvd" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep, _, thr = outliers.mahalanobis_outlier_mask(
            x_dev, n_comp, solver=solver, omega=om)
        keep = keep.cpu().numpy()
        timings[f"outlier_ms_{solver}"] = 1e3 * (time.perf_counter() - t0)
        keep64, _, thr64 = outliers.mahalanobis_outlier_mask(
            x_cpu, n_comp, solver=solver,
            omega=None if om is None else om.double().cpu())
        keep64 = keep64.numpy()
        masks[solver] = {
            "agreement": float(np.mean(keep == keep64)),
            "threshold_rel_err": abs(float(thr) - float(thr64)) / float(thr64),
            "objects_card": len(np.unique(obj_ids[keep])),
            "objects_cpu_f64": len(np.unique(obj_ids[keep64])),
            "same_objects": np.array_equal(np.unique(obj_ids[keep]),
                                           np.unique(obj_ids[keep64]))}
        if solver == "svd":
            kept_rows = int(keep.sum())
    split_rows = sum(res.splits["0"][p].shape[0] for p in
                     ("cal", "val", "test"))
    line = {"phase": "nuts_simca", "x_cal": list(x_cal.shape),
            "x_test": list(x_test.shape), "k1_launches": launches,
            "metrics": est.metrics[0], "class0_pixels": int(x0.shape[0]),
            "class0_objects": len(objs), "outlier_masks_vs_cpu_f64": masks,
            "split_rows_equal_card_mask": split_rows == kept_rows}
    print(json.dumps(line), flush=True)
    check(split_rows == kept_rows, f"class 0's splits hold {split_rows} "
          f"rows, its card mask keeps {kept_rows}")
    for solver, m in masks.items():
        check(m["agreement"] >= 0.999, f"outlier mask ({solver}) card vs CPU "
              f"f64 agreement {m['agreement']}")
        check(m["same_objects"], f"outlier mask ({solver}): surviving objects "
              "differ between the card and CPU f64")
    return launches, timings


def cheese_plsda(dev):
    """Phase 18 C: examples/cheese_eda_plsda.py's PLS-DA on the card (f32)
    and on the port's CPU (f64): the same best k, per-k CV F1 within 0.01,
    test predictions >= 99 % equal. Returns timings."""
    x_tr, y_tr, x_ts, y_ts = synthetic.cheese_like()
    x_tr32, x_ts32 = x_tr.astype(np.float32), x_ts.astype(np.float32)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        curves = plsda.plsda_f1_curves(x_tr32, y_tr, PLS_MAX_K, PLS_FOLDS,
                                       device=dev)
        runs.append(1e3 * (time.perf_counter() - t0))
    timings = {"plsda_curves_ms": statistics.median(runs)}
    best = curves["best_n_components"]
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = plsda.plsda_fit_predict(x_tr32, y_tr, x_ts32, y_ts, best,
                                      device=dev)
        runs.append(1e3 * (time.perf_counter() - t0))
    timings["plsda_fit_ms"] = statistics.median(runs)
    d = plsda.discriminant_vectors(res.pls, res.lda)
    ref = plsda.plsda_f1_curves(x_tr, y_tr, PLS_MAX_K, PLS_FOLDS,
                                device="cpu")
    res64 = plsda.plsda_fit_predict(x_tr, y_tr, x_ts, y_ts, best,
                                    device="cpu")
    d64 = plsda.discriminant_vectors(res64.pls, res64.lda)
    f1_err = float(np.abs(curves["f1_cv"] - ref["f1_cv"]).max())
    cal_err = float(np.abs(curves["f1_cal"] - ref["f1_cal"]).max())
    agree = float(np.mean(res.y_pred == res64.y_pred))
    line = {"phase": "cheese_plsda", "train": list(x_tr.shape),
            "test": list(x_ts.shape), "best_k": best,
            "best_k_cpu_f64": ref["best_n_components"],
            "f1_cv": curves["f1_cv"].tolist(),
            "f1_cv_max_abs_err_vs_cpu_f64": f1_err,
            "f1_cal_max_abs_err_vs_cpu_f64": cal_err,
            "f1_cv_err_by_k": np.abs(curves["f1_cv"] - ref["f1_cv"]).tolist(),
            "test_f1": res.f1_test, "test_f1_cpu_f64": res64.f1_test,
            "test_pred_agreement_vs_cpu_f64": agree,
            "discriminant_vectors_max_abs_err_vs_cpu_f64": float(
                np.abs(d - d64).max()),
            "confusion": res.confusion.tolist()}
    print(json.dumps(line), flush=True)
    check(bool(np.isfinite(d).all()) and d.shape == (x_tr.shape[1], 4),
          f"discriminant vectors {d.shape} not finite")
    check(best == ref["best_n_components"], f"PLS-DA best k {best} on the "
          f"card, {ref['best_n_components']} on the CPU in f64")
    check(f1_err <= 0.01, f"PLS-DA CV F1 off CPU f64 by {f1_err} > 0.01")
    check(agree >= 0.99, f"PLS-DA test predictions agree {agree} < 0.99")
    return timings


def checkpoint_resume(dev):
    """Phase 18 D: the entry model trained 2 epochs, saved by
    ``TrainCheckpointer``, restored by a fresh one and trained 2 more,
    against 4 uninterrupted epochs (losses and weights within 1e-5 of
    their scale). Returns (launches of the 8 epochs, timings)."""
    x = vae_workload()
    cfg2 = vae_trainer.TrainConfig(epochs=2, batch_size=VAE_BATCH, lr=1e-3,
                                   loss_type="bce")
    cfg4 = vae_trainer.TrainConfig(epochs=4, batch_size=VAE_BATCH, lr=1e-3,
                                   loss_type="bce")
    torch.manual_seed(0)
    init = ConvVAE1D(**VAE_KW)
    bn.bn_act_fwd.launches = bn.bn_act_bwd.launches = 0
    kernels.reparam_kl.launches = kernels.reparam_kl_bwd.launches = 0
    part1 = vae_trainer.train_vae(copy.deepcopy(init), x, x[:VAE_BATCH],
                                  cfg2, seed=0, device=dev)
    timings = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        checkpoint.TrainCheckpointer(tmp, max_to_keep=2).save(
            2, part1.final_state, part1.final_opt_state)
        timings["checkpoint_save_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        state, opt_state, epoch = checkpoint.TrainCheckpointer(tmp).restore()
        timings["checkpoint_restore_ms"] = 1e3 * (time.perf_counter() - t0)
    part2 = vae_trainer.train_vae(ConvVAE1D(**VAE_KW), x, x[:VAE_BATCH],
                                  cfg2, seed=0, init_state=(state, opt_state),
                                  epoch_offset=epoch, device=dev)
    full = vae_trainer.train_vae(copy.deepcopy(init), x, x[:VAE_BATCH], cfg4,
                                 seed=0, device=dev)
    torch.cuda.synchronize()
    launches = {"bn_act_fwd": bn.bn_act_fwd.launches,
                "bn_act_bwd": bn.bn_act_bwd.launches,
                "reparam_kl": kernels.reparam_kl.launches,
                "reparam_kl_bwd": kernels.reparam_kl_bwd.launches}
    losses = np.concatenate([part1.train_losses, part2.train_losses,
                             part1.val_losses, part2.val_losses])
    want = np.concatenate([full.train_losses, full.val_losses])
    loss_err = float(np.abs(losses - want).max() / np.abs(want).max())
    w_err = max(rel_err(part2.final_state[k], full.final_state[k])
                for k in full.final_state
                if full.final_state[k].is_floating_point())
    bit_equal = bool(np.array_equal(losses, want) and all(
        torch.equal(part2.final_state[k], full.final_state[k])
        for k in full.final_state))
    steps = 8 * -(-VAE_N // VAE_BATCH)
    print(json.dumps({"phase": "checkpoint_resume", "epoch": epoch,
                      "launches": launches, "loss_rel_err": loss_err,
                      "weights_rel_err": w_err, "bit_equal": bit_equal}),
          flush=True)
    check(epoch == 2, f"restored epoch {epoch} != 2")
    check(launches == {"bn_act_fwd": 6 * steps, "bn_act_bwd": 6 * steps,
                       "reparam_kl": steps + 8, "reparam_kl_bwd": steps},
          f"resume launch counts {launches}")
    check(loss_err <= 1e-5 and w_err <= 1e-5, f"resumed run off the "
          f"uninterrupted one: losses {loss_err}, weights {w_err}")
    return launches, timings


def data_layer_phases(dev, card):
    """Phase 18, the data layer at full width: the nut pipeline (A), the
    nuts SIMCA (B), the cheese PLS-DA (C) and a checkpointed resume (D).
    Returns {kernel record name: launches made on its path}."""
    t_phase = time.perf_counter()
    store, launches, errs, timings = hsi_pipeline(dev, card)
    k1, t = nuts_simca(dev, store)
    del store
    launches["t2q_scores_multiclass"] += k1
    timings.update(t)
    timings.update(cheese_plsda(dev))
    vae_launches, t = checkpoint_resume(dev)
    launches.update(vae_launches)
    timings.update(t)
    timings["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"phase": "data_layer_timings", "card": card,
                      "kernel_errs": errs, **timings}), flush=True)
    return launches


# --- HPO and sweeps (phase 19) ------------------------------------------------

# bench_all.py:284-318's batched sweep: default_rng(4) spectra, 256
# calibration and 64 validation, 8 configs of the entry model
SWEEP_N, SWEEP_CAL, SWEEP_CFGS, SWEEP_EPOCHS = 320, 256, 8, 10
SWEEP_LRS = np.logspace(-4, -2, SWEEP_CFGS)
# the (B, C*F, L) of each BatchNorm of the 8-config stacked entry model
STACKED_BN_SHAPES = [(64, 256, 501), (64, 512, 251), (64, 1024, 126),
                     (64, 512, 252), (64, 256, 504), (64, 256, 504)]
# examples/hpo_nuts.py's adaptive modes at their defaults (target peanut)
HPO_SPACE = {"latent_dim": ("categorical", [8, 16, 32]),
             "lr": ("loguniform", 1e-4, 1e-2),
             "beta": ("loguniform", 1e-3, 4.0)}
HPO_BASE = {"conv_blocks": 3, "n_filters": 16, "hidden_fc": 64,
            "batch_size": 64, "loss_type": "bce"}
HPO_TRIALS, HPO_EPOCHS, HPO_REDUCTION, HPO_SEED = 10, 25, 3, 42
HPO_BRACKETS = 3
VAE_KERNELS = ("bn_act_fwd", "bn_act_bwd", "reparam_kl", "reparam_kl_bwd")


def vae_launch_counts() -> dict:
    return {"bn_act_fwd": bn.bn_act_fwd.launches,
            "bn_act_bwd": bn.bn_act_bwd.launches,
            "reparam_kl": kernels.reparam_kl.launches,
            "reparam_kl_bwd": kernels.reparam_kl_bwd.launches}


def zero_vae_launch_counts():
    bn.bn_act_fwd.launches = bn.bn_act_bwd.launches = 0
    kernels.reparam_kl.launches = kernels.reparam_kl_bwd.launches = 0


def counted(run):
    """``run()`` with the four training kernels' counts set to 0 just
    before and read just after: (out, counts, ms on the host clock)."""
    torch.cuda.synchronize()
    zero_vae_launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, vae_launch_counts(), 1e3 * (time.perf_counter() - t0)


def stacked_launches(bn_layers, steps, epochs, val_every=1):
    """The exact launches of a stacked run, whatever its number of
    configs: K2 and K3 once a BatchNorm layer a step, K4 once a step and
    once a validation, K6's backward once a step."""
    n_val = epochs // val_every
    return {"bn_act_fwd": bn_layers * steps * epochs,
            "bn_act_bwd": bn_layers * steps * epochs,
            "reparam_kl": steps * epochs + n_val,
            "reparam_kl_bwd": steps * epochs}


def stacked_path_bn_shapes(dev, n_cfg):
    """The (B, C*F, L) each BatchNorm of the n-config stacked entry model
    sees in a train step."""
    smodel = stacked.StackedVAE(ConvVAE1D(**VAE_KW), n_cfg).to(dev).train()
    shapes = []
    for mod in smodel.modules():
        if isinstance(mod, stacked.StackedBatchNormAct):
            # its input: the configs' (B, F, L), side by side for K2
            mod.register_forward_hook(lambda m, i, o: shapes.append(
                (i[0][0].shape[0], len(i[0]) * i[0][0].shape[1],
                 i[0][0].shape[2])))
    x = torch.zeros(n_cfg, VAE_BATCH, VAE_KW["input_length"], device=dev)
    with torch.no_grad():
        mu, lv = smodel.encode(x)
        smodel.decode(smodel.reparameterize(mu, lv, torch.zeros_like(mu))[0])
    return shapes


def compare_reparam_per_config(gen, dev, n_cfg=SWEEP_CFGS, batch=VAE_BATCH,
                               k=VAE_KW["latent_dim"]):
    """K4 and K6's backward at the stacked (C*B, k) = (512, 16), the
    backward's dz and dkl caught as autograd hands them to it for the
    stacked loss sum_c beta_c * mean(kl_c) + <w, z>: dkl is beta_c / B,
    different per config.  Exactly one K6 backward launch; both against
    their twins (tolerance 1e-5 of scale)."""
    mu, lv, eps, w = (torch.randn(4, n_cfg * batch, k, generator=gen)
                      * 0.8).to(dev)
    betas = torch.logspace(-3, 0.6, n_cfg, device=dev)
    mu_, lv_ = mu.clone().requires_grad_(), lv.clone().requires_grad_()
    z, kl = kernels.fused_reparam_kl(mu_, lv_, eps)
    caught = {}
    z.register_hook(lambda g: caught.__setitem__("dz", g))
    kl.register_hook(lambda g: caught.__setitem__("dkl", g))
    before = kernels.reparam_kl_bwd.launches
    loss = (w * z).sum() + (betas * kl.view(n_cfg, batch).mean(1)).sum()
    loss.backward()
    torch.cuda.synchronize()
    check(kernels.reparam_kl_bwd.launches == before + 1,
          "the stacked backward did not launch K6's backward exactly once")
    dkl = caught["dkl"]
    ref_z, ref_kl = kernels.reparam_kl_plain(mu, lv, eps)
    ref_dmu, ref_dlv = kernels.reparam_kl_bwd_plain(mu, lv, eps,
                                                    caught["dz"], dkl)
    errs = {"z": rel_err(z.detach(), ref_z), "kl": rel_err(kl.detach(), ref_kl),
            "dmu": rel_err(mu_.grad, ref_dmu), "dlv": rel_err(lv_.grad, ref_dlv)}
    line = {"phase": "reparam_per_config_vs_plain",
            "shape": [n_cfg * batch, k], "dkl_stride": dkl.stride(),
            "dkl_distinct": int(torch.unique(dkl).numel()),
            "rel_err_of_scale": errs}
    print(json.dumps(line), flush=True)
    check(line["dkl_distinct"] == n_cfg, "dkl is not beta_c / B per config")
    for n, e in errs.items():
        check(e <= 1e-5, f"K4/K6 per config: {n} error {e} > 1e-5 of scale")
    return (max((z.detach() - ref_z).abs().max().item(),
                (kl.detach() - ref_kl).abs().max().item()),
            max((mu_.grad - ref_dmu).abs().max().item(),
                (lv_.grad - ref_dlv).abs().max().item()))


def batched_sweep_data():
    """bench_all.py:284-318's data, f32."""
    rng = np.random.default_rng(4)
    t = np.linspace(0, 1, VAE_KW["input_length"])
    return (rng.normal(1, .08, (SWEEP_N, 1)) * np.sin(2 * np.pi * 3 * t)
            + rng.normal(0, .02, (SWEEP_N, VAE_KW["input_length"]))
            ).astype(np.float32)


def batched_sweep(n_cfg=SWEEP_CFGS, epochs=SWEEP_EPOCHS, x=None):
    x = batched_sweep_data() if x is None else x
    return sweep.train_vae_vmapped(
        ConvVAE1D(**VAE_KW), x[:SWEEP_CAL], x[SWEEP_CAL:],
        SWEEP_LRS[:n_cfg], [0.0] * n_cfg, [1.0] * n_cfg, epochs=epochs,
        batch_size=VAE_BATCH, loss_type="cosine", seed=0)


def sequential_sweep(x):
    """The same configs as sequential ``train_vae`` runs (config c: its
    seed's initial weights and streams)."""
    model = ConvVAE1D(**VAE_KW)
    out, ms = [], []
    for c in range(SWEEP_CFGS):
        t0 = time.perf_counter()
        s = stacked.config_seed(0, c)
        cfg = vae_trainer.TrainConfig(epochs=SWEEP_EPOCHS,
                                      batch_size=VAE_BATCH,
                                      lr=float(SWEEP_LRS[c]),
                                      loss_type="cosine")
        out.append(vae_trainer.train_vae(stacked.seeded_vae(model, s),
                                         x[:SWEEP_CAL], x[SWEEP_CAL:], cfg,
                                         seed=s))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, ms


def stacked_vs_sequential(res, seq):
    """Every config of the stacked run against its sequential run: train
    losses within rtol 1e-5, val losses within 2e-3, the same best epoch
    (``tests/test_sweep.py:79-115``'s contract); a config that diverged
    must diverge at the same epochs."""
    worst = {"train": 0.0, "val": 0.0}
    diverged = []
    for c, r in enumerate(seq):
        for key, got, ref, tol in (("train", res.train_losses[c],
                                    r.train_losses, 1e-5),
                                   ("val", res.val_losses[c], r.val_losses,
                                    2e-3)):
            fin = np.isfinite(ref)
            check(np.array_equal(np.isfinite(got), fin),
                  f"config {c}: {key} losses diverge at other epochs "
                  f"({got} vs {ref})")
            if not fin.all():
                diverged.append(c)
            if fin.any():
                e = float(np.max(np.abs(got[fin] - ref[fin])
                                 / np.abs(ref[fin])))
                worst[key] = max(worst[key], e)
                check(e <= tol, f"config {c}: {key} losses differ from the "
                      f"sequential run by {e} > {tol}")
        check(int(res.best_epoch[c]) == int(r.best_epoch),
              f"config {c}: best epoch {res.best_epoch[c]} != "
              f"{r.best_epoch}")
    return worst, sorted(set(diverged))


def stacked_step_vs_cpu_f64(dev, x_np, n_cfg=SWEEP_CFGS):
    """One stacked step of the 8-config entry model from identical weights,
    batches and eps: the card in f32 against the port's CPU in f64.  Loss
    within 1e-4, each gradient within 1e-3 of its norm (or of 1e-3 of the
    whole gradient's norm), as phase 7 holds the single step."""
    template = ConvVAE1D(**VAE_KW)
    models = [stacked.seeded_vae(template, s) for s in range(n_cfg)]
    mean, std = x_np.mean(0), x_np.std(0) + 1e-12
    rows = np.arange(VAE_BATCH)
    xb = np.stack([(x_np[(8 * c + rows) % len(x_np)] - mean) / std
                   for c in range(n_cfg)])
    eps = np.random.default_rng(3).normal(
        size=(n_cfg, VAE_BATCH, VAE_KW["latent_dim"]))
    betas = np.logspace(-2, 0, n_cfg).tolist()
    cfg = vae_trainer.TrainConfig(loss_type="cosine")
    out = []
    for d, dt in ((dev, torch.float32), ("cpu", torch.float64)):
        smodel = stacked.stacked_vae(template, models, device=d,
                                     dtype=dt).train()
        losses = stacked.stacked_step_loss(
            smodel, cfg, torch.as_tensor(xb, dtype=dt, device=d),
            torch.as_tensor(eps, dtype=dt, device=d), betas)
        losses.sum().backward()
        out.append((losses.detach().double().cpu(),
                    {n: p.grad.detach().double().cpu()
                     for n, p in smodel.named_parameters()}))
    (loss, g), (loss_r, g_r) = out
    total = math.sqrt(sum(float(v.norm()) ** 2 for v in g_r.values()))
    errs = {n: float((g[n] - g_r[n]).norm())
            / max(float(g_r[n].norm()), 1e-3 * total) for n in g_r}
    loss_rel = float(((loss - loss_r).abs() / loss_r.abs()).max())
    worst = max(errs, key=errs.get)
    print(json.dumps({"phase": "stacked_step_vs_cpu_f64", "configs": n_cfg,
                      "losses": loss.tolist(), "loss_rel_err": loss_rel,
                      "worst_grad": worst, "worst_grad_err": errs[worst],
                      "grad_norm_cpu_f64": total}), flush=True)
    check(loss_rel <= 1e-4, f"stacked step loss differs from CPU f64 by "
          f"{loss_rel}")
    check(errs[worst] <= 1e-3, f"stacked gradient {worst} differs from "
          f"CPU f64 by {errs[worst]} of its norm")


def asha_schedule(n_trials, max_epochs, reduction):
    """ASHA's rungs and epoch budget, recomputed from its rule alone."""
    k0 = max(1, math.ceil(math.log(max(n_trials, reduction))
                          / math.log(reduction)))
    rungs, r = [], max(1, max_epochs // reduction ** k0)
    while r < max_epochs:
        rungs.append(r)
        r *= reduction
    rungs.append(max_epochs)
    total, alive, prev = 0, n_trials, 0
    for i, target in enumerate(rungs):
        total += (target - prev) * alive
        prev = target
        if i < len(rungs) - 1:
            alive = max(1, math.ceil(alive / reduction))
    return rungs, total


def halving_k2(trials, rungs, steps, bn_layers=6):
    """K2 launches of a successive-halving run: each rung trains each
    architecture group of the trials that reached it as one stacked run
    of (rung - previous rung) epochs."""
    total, prev = 0, 0
    for target in rungs:
        reached = [tr for tr in trials if tr["epochs"] >= target]
        groups = {tr["config"]["latent_dim"] for tr in reached}
        total += bn_layers * steps * (target - prev) * len(groups)
        prev = target
    return total


def hpo_evaluate(out, length, res):
    """hpo_nuts.py's epilogue: the winner's thresholds, then ``decide_f``
    on the test set; returns the test accuracy."""
    cfg = out["best_config"]
    model = ConvVAE1D(input_length=length, latent_dim=int(cfg["latent_dim"]),
                      conv_blocks=3, n_filters=16, hidden_fc=64)
    b = vae_decision.fit_thresholds(model, out["best_bundle"], res.x_cal,
                                    loss_type="bce")
    dec = vae_decision.decide_f(model, b, res.x_test)
    pred = torch.where(dec.accept, 0, 1)
    return float(metrics.vae_binary_metrics(pred, res.y_test, 2,
                                            device=pred.device).accuracy)


def hpo_runs(dev):
    """examples/hpo_nuts.py's three adaptive modes at their defaults, each
    then calibrated and scored; exact K2/K3 launches from the returned
    schedules.  Returns (the runs' launch counts summed, the timings)."""
    data = synthetic.nut_objects()
    length = data["peanut"][0].shape[1]
    res = splits.object_aware_splits(data, list(data), "peanut", length,
                                     verbose=False)
    steps = -(-res.x_cal.shape[0] // HPO_BASE["batch_size"])
    kw = dict(seed=HPO_SEED, base_config=HPO_BASE, verbose=False)
    runs = {
        "asha": lambda: sweep.asha_vae_search(
            res.x_cal, res.x_val, HPO_SPACE, n_trials=HPO_TRIALS,
            max_epochs=HPO_EPOCHS, reduction=HPO_REDUCTION, **kw),
        "tpe": lambda: tpe.tpe_vae_search(
            res.x_cal, res.x_val, HPO_SPACE, n_trials=HPO_TRIALS,
            max_epochs=HPO_EPOCHS, n_warmup_steps=min(10, max(
                2, HPO_EPOCHS // 5)), **kw),
        "bohb": lambda: tpe.bohb_vae_search(
            res.x_cal, res.x_val, HPO_SPACE, n_brackets=HPO_BRACKETS,
            trials_per_bracket=HPO_TRIALS, max_epochs=HPO_EPOCHS,
            reduction=HPO_REDUCTION, **kw)}
    rungs, total = asha_schedule(HPO_TRIALS, HPO_EPOCHS, HPO_REDUCTION)
    line, launches = {"phase": "hpo", "cal": res.x_cal.shape[0],
                      "steps_an_epoch": steps}, {}
    for key, run in runs.items():
        out, counts, ms = counted(run)
        if key == "asha":
            check(out["rungs"] == rungs and out["total_epochs"] == total,
                  f"ASHA's schedule {out['rungs']}, {out['total_epochs']} "
                  f"!= its rule's {rungs}, {total}")
            want = halving_k2(out["trials"], out["rungs"], steps)
        elif key == "bohb":
            want = sum(halving_k2(h["trials"], h["rungs"], steps)
                       for h in out["history"])
        else:
            want = 6 * steps * out["total_epochs"]
        check(counts["bn_act_fwd"] == want == counts["bn_act_bwd"],
              f"{key}: K2/K3 launches {counts} != {want}")
        check(np.isfinite(out["best_value"]), f"{key}: best value not finite")
        budget = HPO_TRIALS * HPO_EPOCHS * (HPO_BRACKETS if key == "bohb"
                                            else 1)
        line[key] = {"ms": ms, "total_epochs": out["total_epochs"],
                     "full_fidelity_epochs": budget,
                     "best_value": out["best_value"],
                     "best_config": out["best_config"], "launches": counts,
                     "test_accuracy": hpo_evaluate(out, length, res)}
        if key == "tpe":
            line[key]["n_pruned"] = out["n_pruned"]
            if out["total_epochs"] >= budget:
                line[key]["why_no_saving"] = (
                    "no trial was pruned: every trial's best loss stayed "
                    "at or below the median of the others at each epoch")
        if key == "asha":
            line[key]["rungs"] = out["rungs"]
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    print(json.dumps(line), flush=True)
    return launches, {f"{k}_ms": line[k]["ms"] for k in runs}


def classes_screen(dev):
    """examples/multiclass_vae_screen.py's class trainer at its defaults
    (every nut class, latent 6, 8 epochs), per-class thresholds, one
    stacked ``VAEScorer`` screen held to the single-class screens (accepts
    bit-equal, statistics within 1e-6 of scale, as phase 10)."""
    data = synthetic.nut_objects(seed=42)
    names = list(data)
    length = data[names[0]][0].shape[1]
    model = ConvVAE1D(input_length=length, latent_dim=6, conv_blocks=2,
                      n_filters=16, hidden_fc=64)
    cfg = vae_trainer.TrainConfig(epochs=8, batch_size=64, lr=1e-3,
                                  loss_type="euclidean")
    sps = [splits.object_aware_splits(data, names, nut, length,
                                      verbose=False) for nut in names]
    res, counts, ms = counted(lambda: sweep.train_vae_classes(
        model, [s.x_cal for s in sps], [s.x_val for s in sps], cfg, seed=42))
    n_max = max(s.x_cal.shape[0] for s in sps)
    want = stacked_launches(4, -(-n_max // cfg.batch_size), cfg.epochs)
    check(counts == want, f"train_vae_classes launches {counts} != {want}")
    check(bool(np.isfinite(res.val_losses).all()),
          "a class's validation loss is not finite")
    fitted = [vae_decision.fit_thresholds(
        model, vae_bundle.class_slice(res.bundle, c), sps[c].x_cal,
        loss_type="euclidean") for c in range(len(names))]
    x_mix = np.concatenate([np.asarray(s.x_test_in, np.float32)
                            for s in sps])
    kw = dict(variant="d2", loss_type="euclidean", chunk_size=2048)
    out = VAEScorer(model, vae_bundle.stack_bundles(fitted), **kw).score(
        x_mix)
    worst = 0.0
    for c, b in enumerate(fitted):
        single = VAEScorer(model, b, **kw).score(x_mix)
        col = {k: v[:, c] for k, v in out.items()}
        check(np.array_equal(col["accept"], single["accept"]),
              f"classes screen: class {c} accepts differ from single")
        worst = max([worst, *stats_rel_err(col, single).values()])
    print(json.dumps({"phase": "classes_screen", "classes": names,
                      "cal_sizes": [s.x_cal.shape[0] for s in sps],
                      "launches": counts, "train_vae_classes_ms": ms,
                      "stats_rel_err": worst,
                      "accept_rate": out["accept"].mean(0).tolist()}),
          flush=True)
    check(worst <= 1e-6, f"classes screen statistics differ by {worst}")
    return counts, ms


def sweep_runner():
    """examples/sweep_vae.py's runner grid into a temporary directory, then
    again: the second call resumes (the same metrics, no launch)."""
    x_tr, y_tr, x_ts, y_ts = synthetic.cheese_like(seed=42)
    # f32 on the card (the kernels take f32; float64 numpy would run the
    # port's f64 parity mode), as the JAX example trains in f32
    x_tr, x_ts = x_tr.astype(np.float32), x_ts.astype(np.float32)
    x_cls = x_tr[y_tr == 0]
    n_val = max(len(x_cls) // 6, 8)
    x_cal, x_val = x_cls[:-n_val], x_cls[-n_val:]
    y_bin = np.where(y_ts == 0, 0, np.maximum(y_ts, 1))
    epochs = 20
    configs = sweep.grid_product(
        {"epochs": epochs, "batch_size": 64, "latent_dim": 8,
         "conv_blocks": 2, "n_filters": 16, "hidden_fc": 64,
         "loss_type": "cosine"}, {"lr": [1e-3, 3e-3], "beta": [0.1, 1.0]})
    with tempfile.TemporaryDirectory() as tmp:
        first, counts, ms = counted(lambda: sweep.run_vae_sweep(
            configs, x_cal, x_val, x_ts, y_bin, tmp, verbose=False))
        again, resumed, resume_ms = counted(lambda: sweep.run_vae_sweep(
            configs, x_cal, x_val, x_ts, y_bin, tmp, verbose=False))
        files = sorted(os.listdir(os.path.join(tmp, "run_0003")))
    steps = -(-x_cal.shape[0] // 64)
    k2 = 4 * steps * epochs * len(configs)
    print(json.dumps({"phase": "sweep_runner", "runs": len(configs),
                      "ms": ms, "resume_ms": resume_ms, "launches": counts,
                      "resumed_launches": resumed, "files": files,
                      "accuracy": [r["accuracy"] for r in first]}),
          flush=True)
    check(counts["bn_act_fwd"] == k2 == counts["bn_act_bwd"],
          f"sweep runner K2/K3 launches {counts} != {k2}")
    check(again == first, "the resumed sweep returned other metrics")
    check(not any(resumed.values()), f"the resumed sweep launched {resumed}")
    check(files == ["losses.json", "metrics.json", "model_bundle.msgpack",
                    "params.json"], f"run artifacts {files}")
    return counts


def grouped_step(smodel, opt, xbs, eps):
    """A yardstick the port does not use: the stacked step with each
    layer batched over the configs (grouped convolutions on (B, C*F, L),
    ``baddbmm`` dense layers, the loss vmapped), on the same parameters,
    kernels and Adam.  It sums in other orders than a lone model, so its
    configs drift from their sequential runs where training is unstable;
    timed beside the port's per-config layers."""
    n = smodel.n

    def run(layers, h):
        for mod in layers:
            if isinstance(mod, stacked.StackedConv1d):
                w = mod.weight
                h = F.conv1d(h, w.reshape(-1, *w.shape[2:]),
                             mod.bias.reshape(-1), mod.stride, mod.padding,
                             groups=n)
            elif isinstance(mod, stacked.StackedConvTranspose1d):
                w = mod.weight
                h = F.conv_transpose1d(h, w.reshape(-1, *w.shape[2:]),
                                       mod.bias.reshape(-1), mod.stride,
                                       mod.padding, mod.output_padding,
                                       groups=n)
            elif isinstance(mod, stacked.StackedBatchNormAct):
                h = bn.fused_bn_act(h, mod.weight.reshape(-1),
                                    mod.bias.reshape(-1), mod.eps, mod.act,
                                    bn.k2_cluster_size(
                                        h.shape[0], h.shape[1] // n,
                                        h.shape[2]))[0]
            elif isinstance(mod, stacked.StackedLinear):
                h = torch.baddbmm(mod.bias.unsqueeze(1), h,
                                  mod.weight.transpose(1, 2))
            elif isinstance(mod, stacked.StackedAct):
                h = bn.apply_act(h, mod.act)
        return h

    h = run(smodel.encoder_conv, xbs.transpose(0, 1))
    h = run(smodel.fc, h.reshape(h.shape[0], n, -1).transpose(0, 1))
    mu, lv = run([smodel.fc_mu], h), run([smodel.fc_logvar], h)
    z, kl = smodel.reparameterize(mu, lv, eps)
    h = run(smodel.fc_dec, z).transpose(0, 1)
    h = run(smodel.decoder_conv, h.reshape(h.shape[0], -1,
                                           smodel.enc_shape[1]))
    x_rec = h.transpose(0, 1)[..., :smodel.input_length]
    losses = torch.vmap(lambda a, b: recon_loss(a, b, "cosine"))(
        xbs, x_rec) + kl.mean(1)
    opt.zero_grad()
    losses.sum().backward()
    opt.step()
    return losses.detach()


def stacked_step_timings(dev, card, x_np, n_cfg=SWEEP_CFGS):
    """The 8-config stacked step, the single step of the entry model and
    the grouped yardstick: each step's time (events, median of 21) and
    device time (``device_ms``), the stacked step's device-busy share (its
    device time over its step time), and a profile of the stacked step
    with its C noise draws (device time by kernel group)."""
    template = ConvVAE1D(**VAE_KW)
    smodel = stacked.stacked_vae(
        template, [stacked.seeded_vae(template, s) for s in range(n_cfg)],
        device=dev)
    opt = stacked.StackedAdam(smodel, SWEEP_LRS[:n_cfg], [0.0] * n_cfg)
    cfg = vae_trainer.TrainConfig(loss_type="cosine")
    step = stacked.make_stacked_train_step(smodel, opt, cfg, [1.0] * n_cfg)
    mean, std = x_np.mean(0), x_np.std(0) + 1e-12
    xb = torch.as_tensor((x_np[:VAE_BATCH] - mean) / std, device=dev)
    xbs = xb.expand(n_cfg, *xb.shape).contiguous()
    gens = [torch.Generator(device=dev).manual_seed(s) for s in range(n_cfg)]

    def noise():
        return torch.stack([torch.randn((VAE_BATCH, VAE_KW["latent_dim"]),
                                        generator=g, device=dev)
                            for g in gens])

    eps = noise()
    model = ConvVAE1D(**VAE_KW).to(dev)
    single = vae_trainer.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3), cfg)
    runs = {"stacked": lambda: step(xbs, eps),
            "single": lambda: single(xb, eps[0]),
            "grouped_yardstick": lambda: grouped_step(smodel, opt, xbs, eps)}
    line = {"phase": "stacked_step_timings", "card": card, "configs": n_cfg}
    for key, fn in runs.items():
        line[f"{key}_step_ms"] = median_ms(fn, 3, 21)
        line[f"{key}_device_ms"] = device_ms(fn, 10)
    for key in ("step", "device"):
        line[f"stacked_{key}_vs_configs_x_single"] = line[
            f"stacked_{key}_ms"] / (n_cfg * line[f"single_{key}_ms"])
    line["stacked_device_busy_share"] = (line["stacked_device_ms"]
                                         / line["stacked_step_ms"])
    breakdown(lambda: step(xbs, noise()), reps=3,
              phase="stacked_step_breakdown")
    print(json.dumps(line), flush=True)
    return line


def sweep_phases(dev, card, gen):
    """Phase 19, HPO and sweeps at full width, as a user calls them;
    returns the K2/K3/K4/K6 launches of the path's runs and the maximum
    errors of the kernels against their twins at the stacked shapes."""
    t_phase, parts = time.perf_counter(), {}
    shapes = stacked_path_bn_shapes(dev, SWEEP_CFGS)
    check(shapes == STACKED_BN_SHAPES,
          f"stacked BatchNorm shapes {shapes} != {STACKED_BN_SHAPES}")
    errs = [compare_bn(sh, "elu", gen, dev) for sh in shapes]
    k2_err, k3_err = max(e[0] for e in errs), max(e[1] for e in errs)
    k4_err, k6_err = compare_reparam_per_config(gen, dev)

    # bench_all's batched sweep: the stacked run (the path), the same
    # configs one by one, then the stacked run again, timed
    x = batched_sweep_data()
    steps = -(-SWEEP_CAL // VAE_BATCH)
    res, counts, first_ms = counted(lambda: batched_sweep(x=x))
    path = dict(counts)
    check(counts == stacked_launches(6, steps, SWEEP_EPOCHS),
          f"8-config stacked run launches {counts}")
    for n_cfg in (1, 3):
        _, c_n, _ = counted(lambda: batched_sweep(n_cfg, 2, x))
        check(c_n == stacked_launches(6, steps, 2),
              f"{n_cfg}-config stacked run launches {c_n}")
    parts["kernels_and_first_run"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    seq, seq_ms = sequential_sweep(x)
    seq_s = time.perf_counter() - t0
    worst, diverged = stacked_vs_sequential(res, seq)
    _, _, batch_ms = counted(lambda: batched_sweep(x=x))
    batch_s = batch_ms / 1e3
    print(json.dumps({
        "phase": "batched_sweep", "card": card, "configs": SWEEP_CFGS,
        "epochs": SWEEP_EPOCHS, "launches": counts,
        "first_call_ms": first_ms, "stacked_s": batch_s,
        "sequential_s": seq_s, "sequential_run_ms": seq_ms,
        "batched_sweep_configs_per_s": SWEEP_CFGS / batch_s,
        "sequential_configs_per_s": SWEEP_CFGS / seq_s,
        "vs_sequential": seq_s / batch_s,
        "worst_rel_err_vs_sequential": worst, "diverged_configs": diverged,
        "best_epoch": res.best_epoch.tolist(),
        "final_train_loss": res.train_losses[:, -1].tolist()}), flush=True)
    parts["batched_sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stacked_step_vs_cpu_f64(dev, x)
    parts["step_vs_cpu_f64"] = time.perf_counter() - t0
    for name, run in (("hpo", hpo_runs), ("classes", classes_screen),
                      ("runner", lambda _: (sweep_runner(),))):
        t0 = time.perf_counter()
        for k, n in run(dev)[0].items():
            path[k] += n
        parts[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timing = stacked_step_timings(dev, card, x)
    parts["step_timings"] = time.perf_counter() - t0
    print(json.dumps({"phase": "hpo_sweeps", "launches": path,
                      "seconds": time.perf_counter() - t_phase,
                      "parts_s": parts,
                      "stacked_step_ms": timing["stacked_step_ms"]}),
          flush=True)
    return path, {"bn_act_fwd": k2_err, "bn_act_bwd": k3_err,
                  "reparam_kl": k4_err, "reparam_kl_bwd": k6_err}


# --- the front doors (phase 20) -----------------------------------------------

# every kernel record's counter, by record name
FRONT_COUNTERS = {
    "t2q_scores_multiclass": (kernels.t2q_scores_multiclass, "launches"),
    "t2q_scores_multiclass_bf16": (kernels.t2q_scores_multiclass,
                                   "launches_bf16"),
    "int8_gemm_s32": (kernels.int8_gemm_s32, "launches"),
    "int8_tile_sum": (kernels.int8_tile_sum, "launches"),
    "bn_act_fwd": (bn.bn_act_fwd, "launches"),
    "bn_act_bwd": (bn.bn_act_bwd, "launches"),
    "reparam_kl": (kernels.reparam_kl, "launches"),
    "reparam_kl_bwd": (kernels.reparam_kl_bwd, "launches"),
    "reparam_kl_sample": (kernels.reparam_kl_sample, "launches")}


def all_counted(run):
    """``run()`` with every kernel's count set to 0 just before and read
    just after: (out, {record: launches}, ms on the host clock)."""
    torch.cuda.synchronize()
    for fn, attr in FRONT_COUNTERS.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return out, {k: getattr(fn, attr)
                 for k, (fn, attr) in FRONT_COUNTERS.items()}, ms


def only(counts, **want):
    """``counts`` equal to ``want`` on the named kernels and 0 elsewhere."""
    return all(counts[k] == want.get(k, 0) for k in counts)


def train_launches(bn_layers, steps, epochs, n_val):
    return {"bn_act_fwd": bn_layers * steps * epochs,
            "bn_act_bwd": bn_layers * steps * epochs,
            "reparam_kl": steps * epochs + n_val,
            "reparam_kl_bwd": steps * epochs}


def asha_launches(out, n_cal, bn_layers=6):
    """K2/K3/K4/K6 launches of an ASHA run over the default space: each
    rung trains each (latent_dim, batch_size) group of the trials that
    reached it as one stacked run of (rung - previous rung) epochs, with
    one validation an epoch."""
    want, prev = dict.fromkeys(VAE_KERNELS, 0), 0
    for target in out["rungs"]:
        groups = {(tr["config"].get("latent_dim", 16),
                   int(tr["config"].get("batch_size", 64)))
                  for tr in out["trials"] if tr["epochs"] >= target}
        for _, bs in groups:
            steps = -(-n_cal // min(bs, n_cal))
            for k, n in train_launches(bn_layers, steps, target - prev,
                                       target - prev).items():
                want[k] += n
        prev = target
    return want


def f1_on_card(dev):
    """Phase 20.1: fault F1.  cheese_like()'s float64 arrays, not cast, go
    through SIMCA, fit_classes + predict_classes, train_vae,
    train_vae_classes and ASHA in float32 with their exact launches; an
    explicit float64 CUDA tensor is refused at the entry point.  Returns
    {kernel record name: launches}."""
    from ocm_tpu_torch import cli

    x_tr, y_tr, x_ts, _ = synthetic.cheese_like()
    check(x_tr.dtype == np.float64, f"cheese_like gave {x_tr.dtype}")
    labels = sorted(int(c) for c in np.unique(y_tr))
    launches = {}

    def add(c):
        for k, n in c.items():
            launches[k] = launches.get(k, 0) + n

    est = SIMCA(n_components=10, model_class=0, verbose=False)
    _, c, _ = all_counted(lambda: est.fit(x_tr, y_tr).predict(x_ts))
    check(only(c, t2q_scores_multiclass=1), f"F1 SIMCA launches {c}")
    check(est._model[0].mean.dtype == torch.float32, "F1 SIMCA not f32")
    add(c)
    models = fit_classes(x_tr, y_tr, labels, 10)
    (acc, dred, _, _), c, _ = all_counted(lambda: predict_classes(models,
                                                                  x_ts))
    check(only(c, t2q_scores_multiclass=1), f"F1 predict_classes {c}")
    check(models.mean.dtype == dred.dtype == torch.float32
          and acc.shape == (5, len(x_ts)),
          f"F1 predict_classes {dred.dtype} {tuple(acc.shape)}")
    add(c)
    try:
        predict_classes(models, torch.as_tensor(x_ts, device=dev))
        refused = False
    except ValueError as e:
        refused = "K1" in str(e)
    check(refused, "a float64 CUDA tensor was not refused by K1's entry")

    splits_ = [cli._class_split(x_tr, y_tr, cls) for cls in labels]
    cfg = vae_trainer.TrainConfig(epochs=2, batch_size=64)
    x_cal, x_val = splits_[0]
    r, c, _ = all_counted(lambda: vae_trainer.train_vae(
        ConvVAE1D(**VAE_KW), x_cal, x_val, cfg, seed=0))
    steps = -(-len(x_cal) // 64)
    check(only(c, **train_launches(6, steps, 2, 2)),
          f"F1 train_vae launches {c}")
    check(r.bundle.spec_mean.dtype == torch.float32, "F1 train_vae not f32")
    add(c)
    r, c, _ = all_counted(lambda: sweep.train_vae_classes(
        ConvVAE1D(**VAE_KW), [s[0] for s in splits_],
        [s[1] for s in splits_], cfg, 0))
    steps = -(-max(len(s[0]) for s in splits_) // 64)
    check(only(c, **train_launches(6, steps, 2, 2)),
          f"F1 train_vae_classes launches {c}")
    check(r.bundle.spec_mean.dtype == torch.float32,
          "F1 train_vae_classes not f32")
    add(c)
    out, c, _ = all_counted(lambda: sweep.asha_vae_search(
        x_cal, x_val, n_trials=2, max_epochs=2, verbose=False))
    want = asha_launches(out, len(x_cal))
    check(only(c, **want) and want["bn_act_fwd"] > 0,
          f"F1 ASHA launches {c} != {want}")
    check(out["best_bundle"].spec_mean.dtype == torch.float32,
          "F1 ASHA not f32")
    add(c)
    try:
        vae_trainer.train_vae(ConvVAE1D(**VAE_KW),
                              torch.as_tensor(x_cal, device=dev), x_val,
                              cfg, seed=0)
        refused = False
    except ValueError as e:
        refused = "K2" in str(e)
    check(refused, "a float64 CUDA tensor was not refused by K2's entry")
    print(json.dumps({"phase": "f1_on_card", "input_dtype": str(x_tr.dtype),
                      "compute_dtype": "float32", "launches": launches}),
          flush=True)
    return launches


def cli_call(argv, times, name):
    """``cli.main(argv)`` in-process: its launches, its host-clock time
    under ``name``; fails unless it returns 0.  What the command prints
    goes to a buffer (its run dir holds the same)."""
    import io

    from ocm_tpu_torch import cli

    with contextlib.redirect_stdout(io.StringIO()):
        rc, counts, ms = all_counted(lambda: cli.main(argv))
    check(rc == 0, f"`{' '.join(argv)}` returned {rc}")
    times[name] = ms
    return counts


def read_json(run_dir, name):
    with open(os.path.join(run_dir, name)) as f:
        return json.load(f)


def model_limits(run_dir):
    from ocm_tpu_torch.models.simca import load_simca_model

    m = load_simca_model(os.path.join(run_dir, "simca_model.msgpack"),
                         device="cpu")
    return {"t2": m.t2_res.limit.double(), "q": m.q_res.limit.double(),
            "d": m.d_limit.double()}


def limits_rel(card_dir, cpu_dir):
    a, b = model_limits(card_dir), model_limits(cpu_dir)
    return max(((a[k] - b[k]).abs() / b[k].abs()).max().item() for k in a)


def metrics_within(card, cpu, y, samples=2):
    """Each class's sensitivity and specificity (x100) within ``samples``
    samples of the CPU's."""
    y = np.asarray(y)
    worst = 0.0
    for cls, m in cpu.items():
        n_pos = int(np.sum(y == int(cls)))
        for key, n in (("sensitivity", n_pos), ("specificity",
                                                len(y) - n_pos)):
            worst = max(worst, abs(card[cls][key] - m[key]) * n / 100.0)
    return worst <= samples, worst


def screen_accept(run_dir):
    return np.load(os.path.join(run_dir, "predictions.npz"))["accept"]


def capture_k1_operands(run):
    """(x, mean, components, invcovT) of the first K1 launch that ``run()``
    makes through ``models.simca`` (a SIMCA scorer's exact operands)."""
    from ocm_tpu_torch.models import simca as simca_mod

    seen, real = [], simca_mod.t2q_scores_multiclass

    def recording(*args):
        seen.append(args)
        return real(*args)

    simca_mod.t2q_scores_multiclass = recording
    try:
        run()
    finally:
        simca_mod.t2q_scores_multiclass = real
    return seen[0]


def screen_kernels_vs_plain(run_dir, x, screened, dev):
    """K1 (f32 and bf16 x) and K8 at the operands a run dir's screens give
    them, against their plain twins; each K1 path's decisions
    (``screened``, the accepts its screen wrote, by store width) held
    against the twin's too.  Returns {kernel record name: max abs error}."""
    from ocm_tpu_torch import cli

    model, meta = cli._load_simca_model(run_dir, dev)
    models = model if model.mean.dim() == 2 else stack_models([model])
    c, k, length = models.components.shape
    tag = f"{os.path.basename(run_dir)} L={length} C={c} k={k}"
    errs = {}
    for sd, rec in ((None, "t2q_scores_multiclass"),
                    ("bf16", "t2q_scores_multiclass_bf16")):
        scorer = cli._build_scorer(run_dir, store_dtype=sd, device=dev)[0]
        xk, mean, _, _ = capture_k1_operands(lambda: scorer.score(x))
        check(xk.dtype == (torch.bfloat16 if sd else torch.float32),
              f"{tag}: K1 read {xk.dtype} under --store-dtype {sd}")
        # the chunk's pad rows repeat its last row, and so its decisions
        acc = screened[sd or "f32"].reshape(len(x), c)
        pad = np.repeat(acc[-1:], xk.shape[0] - len(x), axis=0)
        path = torch.as_tensor(np.concatenate([acc, pad]).T, device=dev)
        errs[rec] = compare_kernel(
            f"{tag} N={xk.shape[0]} {sd or 'f32'}", xk,
            models._replace(mean=mean), meta["decision_type"],
            path_accept=path)
    scorer = cli._build_scorer(run_dir, store_dtype="int8", device=dev)[0]
    xq, w = capture_k8_operands(lambda: scorer.score(x))
    errs["int8_gemm_s32"] = k8_vs_plain(f"{tag} N={xq.shape[0]} int8", xq, w)
    return errs


def simca_commands(tmp, times, dev):
    """Phase 20.2: the SIMCA commands on the card at cheese width, each
    f32 run dir screened in f32, bf16 and int8 with exact launches, the
    bf16 and int8 screens held to phase 16's contract against the f32
    screen, K1/bf16 K1/K8 against their twins at the screens' operands,
    and the card against the same commands with --platform cpu.  Returns
    ({kernel record name: launches counted on the path}, {record: max
    abs error})."""
    from ocm_tpu_torch import cli

    _, _, x_ts, y_ts = cli.load_dataset(None)
    chunks = -(-len(x_ts) // 8192)
    runs = {"simca": ["simca", "--quiet"],
            "simca_all": ["simca", "--all-classes", "--quiet"],
            "cv": ["cv", "--refit"]}
    launches, report, errs = {}, {}, {}

    def add(c):
        for k, n in c.items():
            launches[k] = launches.get(k, 0) + n

    for name, argv in runs.items():
        for plat in ("cuda", "cpu"):
            c = cli_call(argv + ["--platform", plat, "--out-dir",
                                 f"{tmp}/{name}_{plat}"], times,
                         f"{name}_{plat}")
            if plat == "cuda":
                want = 0 if name == "cv" else 1
                check(only(c, t2q_scores_multiclass=want),
                      f"{name} launches {c}")
                add(c)
    for plat in ("cuda", "cpu"):
        mom = f"{tmp}/mom_{plat}.msgpack"
        for split in ("train", "test"):
            c = cli_call(["stream-update", "--moments", mom, "--split", split,
                          "--target-class", "0", "--platform", plat], times,
                         f"stream_update_{split}_{plat}")
            check(only(c), f"stream-update launches {c}")
        c = cli_call(["stream-fit", "--moments", mom, "--platform", plat,
                      "--out-dir", f"{tmp}/stream_{plat}"], times,
                     f"stream_fit_{plat}")
        check(only(c), f"stream-fit launches {c}")
        c = cli_call(["plsda", "--platform", plat, "--out-dir",
                      f"{tmp}/plsda_{plat}"], times, f"plsda_{plat}")
        check(only(c), f"plsda launches {c}")
    for name in ("simca", "simca_all", "cv", "stream"):
        report[name] = {"limits_rel_vs_cpu": limits_rel(
            f"{tmp}/{name}_cuda", f"{tmp}/{name}_cpu")}
        check(report[name]["limits_rel_vs_cpu"] <= 1e-3,
              f"{name}: limits {report[name]} off the CPU f64 fit")
        for plat in ("cuda", "cpu"):
            c = cli_call(["screen", "--model-dir", f"{tmp}/{name}_{plat}",
                          "--platform", plat, "--out-dir",
                          f"{tmp}/scr_{name}_{plat}"], times,
                         f"screen_{name}_{plat}")
            if plat == "cuda":
                check(only(c, t2q_scores_multiclass=chunks),
                      f"screen {name} f32 launches {c}")
                add(c)
        card = read_json(f"{tmp}/scr_{name}_cuda", "metrics.json")
        cpu = read_json(f"{tmp}/scr_{name}_cpu", "metrics.json")
        check(all(np.isfinite(v) for m in card.values() for v in m.values()),
              f"screen {name}: metrics not finite {card}")
        ok, worst = metrics_within(card, cpu, y_ts)
        agree = float(np.mean(screen_accept(f"{tmp}/scr_{name}_cuda")
                              == screen_accept(f"{tmp}/scr_{name}_cpu")))
        report[name].update(worst_samples=worst, accept_agreement=agree)
        check(ok, f"screen {name}: card metrics {worst} samples off CPU")
        check(agree >= 0.999, f"screen {name}: accepts {agree} vs CPU")
        f32 = dict(np.load(f"{tmp}/scr_{name}_cuda/predictions.npz"))
        screened = {"f32": f32["accept"]}
        for sd, want in (("bf16", {"t2q_scores_multiclass_bf16": chunks}),
                         ("int8", {"int8_gemm_s32": chunks})):
            c = cli_call(["screen", "--model-dir", f"{tmp}/{name}_cuda",
                          "--store-dtype", sd, "--out-dir",
                          f"{tmp}/scr_{name}_{sd}"], times,
                         f"screen_{name}_{sd}")
            check(only(c, **want), f"screen {name} {sd} launches {c}")
            add(c)
            m = read_json(f"{tmp}/scr_{name}_{sd}", "metrics.json")
            check(all(np.isfinite(v) for mm in m.values()
                      for v in mm.values()), f"{name} {sd} metrics {m}")
            got = dict(np.load(f"{tmp}/scr_{name}_{sd}/predictions.npz"))
            screened[sd] = got["accept"]
            # phase 16's contract for the reduced store widths
            agree, dred = agreement(got, f32)
            report[name][f"{sd}_vs_f32"] = {"accept": agree,
                                            "dred_of_max": dred}
            check(agree >= 0.995, f"screen {name} {sd}: accepts vs f32 "
                  f"{agree} < 0.995")
            check(dred <= 3e-2, f"screen {name} {sd}: dred vs f32 {dred} "
                  "> 3e-2 of max")
        for k, e in screen_kernels_vs_plain(f"{tmp}/{name}_cuda", x_ts,
                                            screened, dev).items():
            errs[k] = max(errs.get(k, 0.0), e)
    for name in ("simca", "simca_all"):
        card, cpu = (read_json(f"{tmp}/{name}_{p}", "metrics.json")
                     for p in ("cuda", "cpu"))
        check(all(np.isfinite(v) for m in card.values() for v in m.values()
                  if isinstance(v, float)), f"{name} metrics {card}")
        ok, worst = metrics_within(card, cpu, y_ts)
        report[name]["command_worst_samples"] = worst
        check(ok, f"{name}: its metrics {worst} samples off the CPU's")
    cv_card, cv_cpu = (read_json(f"{tmp}/cv_{p}", "cv.json")
                       for p in ("cuda", "cpu"))
    check(all(np.isfinite(cv_card[k]).all() for k in ("spec", "sens", "eff")),
          f"cv.json not finite {cv_card}")
    report["cv"]["best_lv"] = [cv_card["best_lv"], cv_cpu["best_lv"]]
    pl_card, pl_cpu = (read_json(f"{tmp}/plsda_{p}", "metrics.json")
                       for p in ("cuda", "cpu"))
    report["plsda"] = {"best_k": [pl_card["best_n_components"],
                                  pl_cpu["best_n_components"]],
                       "f1_test": [pl_card["f1_test"], pl_cpu["f1_test"]]}
    check(np.isfinite(pl_card["f1_test"])
          and pl_card["best_n_components"] == pl_cpu["best_n_components"]
          and abs(pl_card["f1_test"] - pl_cpu["f1_test"]) <= 0.01,
          f"plsda card vs CPU {report['plsda']}")
    print(json.dumps({"phase": "front_doors_simca", "vs_cpu_f64": report,
                      "n_test": len(x_ts), "launches": launches,
                      "max_abs_err": errs}), flush=True)
    return launches, errs


def vae_commands(tmp, times):
    """Phase 20.3: the VAE commands at the CLI's defaults (the entry model
    ConvVAE1D(501, 16), 100 epochs), their screens, hpo and export-torch."""
    from ocm_tpu_torch import cli

    x_tr, y_tr, x_ts, _ = cli.load_dataset(None)
    labels = sorted(int(c) for c in np.unique(y_tr))
    n_cal = len(cli._class_split(x_tr, y_tr, 0)[0])
    n_max = max(len(cli._class_split(x_tr, y_tr, c)[0]) for c in labels)
    launches = dict.fromkeys(VAE_KERNELS, 0)
    vae_dir, all_dir = f"{tmp}/vae", f"{tmp}/vae_all"
    c = cli_call(["train-vae", "--out-dir", vae_dir], times, "train_vae")
    want = train_launches(6, -(-n_cal // 64), 100, 100)
    check(only(c, **want), f"train-vae launches {c} != {want}")
    for k in VAE_KERNELS:
        launches[k] += c[k]
    losses = read_json(vae_dir, "losses.json")
    tl = np.asarray(losses["train_losses"])
    check(np.isfinite(tl).all() and np.isfinite(losses["val_losses"]).all()
          and tl[-1] < tl[0], f"train-vae losses {tl[0]} -> {tl[-1]}")
    c = cli_call(["train-vae", "--all-classes", "--out-dir", all_dir], times,
                 "train_vae_all_classes")
    want = train_launches(6, -(-n_max // 64), 100, 100)
    check(only(c, **want), f"train-vae --all-classes launches {c} != {want}")
    for k in VAE_KERNELS:
        launches[k] += c[k]
    for run_dir in (vae_dir, all_dir):
        m = read_json(run_dir, "metrics.json")
        flat = [v for var in m.values() for mm in (
            var.values() if isinstance(next(iter(var.values())), dict)
            else [var]) for v in mm.values()]
        check(all(np.isfinite(v) for v in flat), f"{run_dir} metrics")
    for run_dir, tag in ((vae_dir, "vae"), (all_dir, "vae_all")):
        for extra in (["--variant", "d2"], ["--variant", "d2_q"],
                      ["--variant", "f"], ["--variant", "full"],
                      ["--variant", "vaesimca"],
                      ["--variant", "d2", "--store-dtype", "bf16"]):
            name = f"screen_{tag}_{'_'.join(extra[1::2])}"
            c = cli_call(["screen", "--model-dir", run_dir, "--out-dir",
                          f"{tmp}/{name}"] + extra, times, name)
            check(only(c), f"{name} launches {c} (no kernel, no K5)")
    hpo_dir, searched, real_asha = f"{tmp}/hpo", [], sweep.asha_vae_search

    def recording(*args, **kwargs):
        searched.append(real_asha(*args, **kwargs))
        return searched[-1]

    sweep.asha_vae_search = recording     # the search's rungs and trials
    try:
        c = cli_call(["hpo", "--algo", "asha", "--quiet", "--out-dir",
                      hpo_dir], times, "hpo_asha")
    finally:
        sweep.asha_vae_search = real_asha
    want = asha_launches(searched[0], n_cal)
    check(len(searched) == 1 and want["bn_act_fwd"] > 0 and only(c, **want),
          f"hpo launches {c} != {want}")
    check(np.isfinite(read_json(hpo_dir, "params.json")["best_value"]),
          "hpo best value not finite")
    for k in VAE_KERNELS:
        launches[k] += c[k]
    pth = f"{tmp}/model.pth"
    c = cli_call(["export-torch", "--model-dir", vae_dir, "--out", pth],
                 times, "export_torch")
    check(only(c), f"export-torch launches {c}")
    model = cli._build_vae(read_json(vae_dir, "params.json")["arch"])
    t0 = time.perf_counter()
    got = VAEScorer.from_torch_checkpoint(pth, model, variant="d2").score(
        x_ts)
    times["from_torch_checkpoint_screen"] = 1e3 * (time.perf_counter() - t0)
    ref = np.load(f"{tmp}/screen_vae_d2/predictions.npz")
    check(set(got) == set(ref.files) and all(
        np.array_equal(got[k], ref[k]) for k in got),
        "the .pth screen differs from the run dir's screen")
    print(json.dumps({"phase": "front_doors_vae", "n_cal": n_cal,
                      "n_max": n_max, "launches": launches,
                      "final_train_loss": float(tl[-1]),
                      "best_epoch": losses["best_epoch"]}), flush=True)
    return launches, vae_dir


def post(srv, body, ctype, path="/score", accept=None):
    import urllib.request

    headers = {"Content-Type": ctype, **({"Accept": accept} if accept
                                          else {})}
    req = urllib.request.Request(f"http://{srv.host}:{srv.port}{path}",
                                 data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers["Content-Type"], r.read()


def npz_bytes(x):
    import io

    buf = io.BytesIO()
    np.savez(buf, x=x)
    return buf.getvalue()


def npz_post(srv, x):
    import io

    status, ctype, body = post(srv, npz_bytes(x), "application/x-npz",
                               accept="application/x-npz")
    check(status == 200 and ctype == "application/x-npz",
          f"npz request {status} {ctype}")
    with np.load(io.BytesIO(body)) as z:
        return {k: z[k] for k in z.files}


def json_post(srv, x, path="/score"):
    body = json.dumps({"x": np.asarray(x).tolist()}).encode()
    status, _, out = post(srv, body, "application/json", path)
    check(status == 200, f"JSON request {status}")
    return json.loads(out)


def quantiles_ms(samples):
    s = sorted(samples)
    return {"p50_ms": s[len(s) // 2],
            "p99_ms": s[min(len(s) - 1, int(math.ceil(0.99 * len(s))) - 1)]}


def server_phase(tmp, vae_dir, times, card):
    """Phase 20.4: the HTTP server over the stacked SIMCA run dir.
    Returns (its figures, the 65,536-spectrum request's launches)."""
    import threading
    import urllib.error

    from ocm_tpu_torch import cli
    from ocm_tpu_torch.server import ScoringServer

    args = cli.build_parser().parse_args(
        ["serve", "--model-dir", f"{tmp}/simca_all_cuda", "--port", "0"])
    args.device = torch.device("cuda")
    t0 = time.perf_counter()
    srv = cli.make_server(args)
    srv.warmup()
    times["server_build_and_warmup"] = 1e3 * (time.perf_counter() - t0)
    srv.start()
    report = {}
    try:
        _, _, x_ts, _ = cli.load_dataset(None)
        rng = np.random.default_rng(20)
        big = (x_ts[rng.integers(0, len(x_ts), 65536)]
               + rng.normal(0, 0.01, (65536, x_ts.shape[1]))).astype(
                   np.float32)
        got, launches, ms = all_counted(lambda: npz_post(srv, big))
        check(only(launches, t2q_scores_multiclass=8),
              f"65,536-spectrum request launches {launches}")
        report["npz_65536_ms"] = ms
        report["npz_65536_spectra_per_s"] = 65536 / (ms / 1e3)
        direct = srv.scorer.score(big)
        check(set(got) == set(direct) and all(
            np.array_equal(got[k], direct[k]) for k in got),
            "the server's 65,536-spectrum answer differs from score()")
        small = big[:16]
        out = json_post(srv, small)
        ref = srv.scorer.score(small)
        check(np.array_equal(np.asarray(out["accept"]), ref["accept"]),
              "JSON answer differs from score()")
        results, errors = [None] * 8, []

        def worker(i):
            try:
                results[i] = json_post(srv, small)["accept"]
            except Exception as e:      # reported by the check below
                errors.append(repr(e))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not errors and all(np.array_equal(np.asarray(r),
                                                ref["accept"])
                                 for r in results),
              f"8 concurrent posts: {errors}")
        lat = []
        for i in range(50):
            t0 = time.perf_counter()
            json_post(srv, big[i:i + 1])
            lat.append(1e3 * (time.perf_counter() - t0))
        report["json_1_spectrum"] = quantiles_ms(lat)
        mid = big[:8192]
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            npz_post(srv, mid)
            lat.append(1e3 * (time.perf_counter() - t0))
        report["npz_8192"] = quantiles_ms(lat)
        report["npz_8192_spectra_per_s"] = 8192 / (
            report["npz_8192"]["p50_ms"] / 1e3)
    finally:
        srv.stop()

    # 429: max_queue=1 while a request holds the device lock
    one = ScoringServer(srv.scorer, srv.info, max_queue=1,
                        expected_length=srv.expected_length).start()
    codes = []
    try:
        with one._lock:
            holder = threading.Thread(target=lambda: codes.append(
                len(json_post(one, big[:2])["accept"]) and 200))
            holder.start()
            deadline = time.time() + 30
            while one._slots._value and time.time() < deadline:
                time.sleep(0.01)
            try:
                json_post(one, big[:2])
                codes.append("no 429")
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                e.close()
        holder.join(timeout=120)
    finally:
        one.stop()
    check(sorted(map(str, codes)) == ["200", "429"], f"429 check {codes}")

    # /reload onto the train-vae run dir, then a VAE score
    srv2 = cli.make_server(args).start()
    try:
        status, _, body = post(srv2, json.dumps({"model_dir": vae_dir})
                               .encode(), "application/json", "/reload")
        info = json.loads(body)["info"]
        check(status == 200 and info["kind"] == "vae",
              f"/reload to the VAE run dir: {status} {info}")
        out = json_post(srv2, x_ts[:5])
        check(len(out["accept"]) == 5 and np.isfinite(out["d2"]).all(),
              f"VAE score after /reload {out}")
    finally:
        srv2.stop()
    print(json.dumps({"phase": "server", "card": card, **report}),
          flush=True)
    return report, launches


def front_door_phases(dev, card):
    """Phase 20, the front doors as a user drives them: F1 on the card,
    the SIMCA and VAE commands in-process through ``cli.main``, the HTTP
    server, and ``python -m ocm_tpu_torch info`` in a subprocess.  Returns
    ({kernel record name: launches made on its path}, {record: max abs
    error against its twin at this phase's operands})."""
    t_phase, times = time.perf_counter(), {}
    t0 = time.perf_counter()
    launches = f1_on_card(dev)
    times["f1_on_card"] = 1e3 * (time.perf_counter() - t0)
    r = subprocess.run([sys.executable, "-m", "ocm_tpu_torch", "info"],
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    check(r.returncode == 0 and "kernel library built: True" in r.stdout
          and "tf32: matmul=False cudnn=False" in r.stdout,
          f"python -m ocm_tpu_torch info: {r.returncode} {r.stdout}"
          f"{r.stderr}")
    print(r.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        (simca, errs), (vae, vae_dir) = (simca_commands(tmp, times, dev),
                                         vae_commands(tmp, times))
        for k, n in (*simca.items(), *vae.items()):
            launches[k] = launches.get(k, 0) + n
        server, k1 = server_phase(tmp, vae_dir, times, card)
        for k, n in k1.items():
            launches[k] = launches.get(k, 0) + n
    print(json.dumps({"phase": "front_door_timings", "card": card,
                      "seconds": time.perf_counter() - t_phase,
                      "command_ms": times, "server": server}), flush=True)
    return launches, errs


# --- phase 21: the sharded paths (ocm_tpu_torch/parallel) -----------------

# train_vae_dp of the entry model on bench_all's 640 spectra at global batch
# 64: 3 epochs, cut from train_vae's 20 (phase 7) for the phase's 90 s
PAR_DP_EPOCHS = 3
# the rank processes' group timeout and the parent's wait for their answers
PAR_TIMEOUT_S = 300


def _np_tree(tree):
    """Tensors of a tree of dicts, tuples and lists as numpy."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_np_tree(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def finite_rel(got, ref):
    """Max relative error over the finite entries of ``ref``; inf where the
    two are not finite at the same entries (a diverged config must diverge
    at the same epochs in both runs)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ok = np.isfinite(ref)
    if not np.array_equal(ok, np.isfinite(got)):
        return math.inf
    return float(np.max(np.abs(got[ok] - ref[ok]) / np.abs(ref[ok]),
                        initial=0.0))


def dp_step_vs_single(dev, mesh):
    """One data-parallel step of the entry model (cross-replica BatchNorm,
    this rank's rows of the global batch of 64) against the single-process
    step on the whole batch, the same weights, batch and noise: (loss
    relative error, gradient error over the gradient norm, K2-K6 launches
    of the DP step)."""
    from ocm_tpu_torch.parallel.train_dist import make_dp_train_step

    x = vae_workload()
    mean, std = vae_bundle.spectral_stats(x)
    xb = torch.as_tensor((x[:VAE_BATCH] - mean) / std, device=dev)
    eps = torch.randn(VAE_BATCH, VAE_KW["latent_dim"],
                      generator=torch.Generator().manual_seed(21)).to(dev)
    cfg = vae_trainer.TrainConfig(batch_size=VAE_BATCH, lr=1e-3,
                                  loss_type="bce")
    grads = []
    for dp in (True, False):
        model = ConvVAE1D(**VAE_KW, bn_axis_name="data" if dp else None)
        model.to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
        if dp:
            step = make_dp_train_step(model, opt, cfg, mesh)
            rows = mesh.rows(VAE_BATCH, "data")
            loss, counts, _ = all_counted(lambda: step(xb[rows], eps[rows]))
        else:
            loss = vae_trainer.make_train_step(model, opt, cfg)(xb, eps)
        grads.append((float(loss), torch.cat([p.grad.reshape(-1)
                                              for p in model.parameters()])))
    (l_dp, g_dp), (l_sp, g_sp) = grads
    return (abs(l_dp - l_sp) / abs(l_sp),
            float((g_dp - g_sp).norm() / g_sp.norm()), counts)


def parallel_workloads(dev, refs, full: bool) -> dict:
    """Phase 21's workloads on this rank, each driven as a user calls it
    with every kernel's count set to 0 just before and read just after:
    {workload: (result as numpy, launches, host ms)}.  ``full`` False runs
    the single-rank NCCL subset (the fit, ``predict_sharded``, one DP step
    and the 8-config sweep)."""
    from ocm_tpu_torch.models.simca import (simca_model_from_numpy,
                                            simca_model_to_numpy)
    from ocm_tpu_torch.parallel import mesh as pm
    from ocm_tpu_torch.parallel import simca_dist, sweep_dist, train_dist

    dmesh = pm.make_mesh(axis_names=("data",), device=dev)
    mmesh = pm.make_mesh(axis_names=("model",), device=dev)
    world = dmesh.size
    # the 2-D sweep's mesh: (1, 2) on pass (b)'s two ranks
    mesh2 = pm.make_mesh((1, world), ("model", "data"), device=dev)
    out = {}

    def run(name, fn):
        res, counts, ms = all_counted(fn)
        out[name] = (_np_tree(res), counts, ms)
        return res

    # the fit and screen of examples/distributed_scoring.py: bench class 0
    # fitted sample-sharded, the 98,304 bench spectra scored sharded
    cals, xs = make_data()
    x_pad, n_true = pm.pad_to_multiple(cals[0].astype(np.float32), world)
    w = (np.arange(x_pad.shape[0]) < n_true).astype(np.float32)
    fitted = {}
    for solver in ("rsvd", "eigh") if full else ("rsvd",):
        fitted[solver] = run(f"fit_{solver}",
                             lambda: simca_dist.fit_simca_sharded(
                                 x_pad, w, K, dmesh, solver=solver))
        out[f"fit_{solver}"] = (simca_model_to_numpy(fitted[solver]),
                                *out[f"fit_{solver}"][1:])
    xs32 = xs.astype(np.float32)
    del xs
    run("predict", lambda: simca_dist.predict_sharded(fitted["rsvd"], xs32,
                                                      dmesh))
    t0 = time.perf_counter()
    loss_rel, grad_rel, counts = dp_step_vs_single(dev, dmesh)
    out["dp_step"] = ((loss_rel, grad_rel), counts,
                      1e3 * (time.perf_counter() - t0))
    x = batched_sweep_data()
    run("sweep", lambda: sweep_dist.train_vae_vmapped_sharded(
        ConvVAE1D(**VAE_KW), x[:SWEEP_CAL], x[SWEEP_CAL:], SWEEP_LRS,
        [0.0] * SWEEP_CFGS, [1.0] * SWEEP_CFGS, mmesh, epochs=SWEEP_EPOCHS,
        batch_size=VAE_BATCH, loss_type="cosine", seed=0)._replace(
            bundle=None, final_state=None, final_opt_state=None))
    if not full:
        return out

    labels = np.repeat(np.arange(N_CLASSES), N_CAL)
    cal32 = cals.reshape(-1, LENGTH).astype(np.float32)
    order = np.random.default_rng(7).permutation(len(labels))

    def moments():
        mom = streaming.moments_init(LENGTH, device=dev)
        for i in range(0, len(order), SRV_BATCH):
            idx = order[i:i + SRV_BATCH]
            mom = simca_dist.moments_update_sharded(
                mom, cal32[idx], dmesh, w=(labels[idx] == 0))
        return mom

    run("moments", moments)
    xcv, ycv = cv_data()
    kw = dict(n_splits=CV_FOLDS, solver="rsvd")
    run("cv", lambda: simca_dist.cv_sweep_sharded(xcv, ycv, 0, CV_LVS, mmesh,
                                                  **kw))
    run("cv_multiclass", lambda: simca_dist.cv_sweep_sharded_multiclass(
        xcv, ycv, [0, 1], CV_LVS, mmesh, **kw))
    run("cv_2d", lambda: simca_dist.cv_sweep_sharded_2d(
        xcv, ycv, 0, CV_LVS, mesh2, **kw))
    xv = vae_workload()
    run("train_vae_dp", lambda: train_dist.train_vae_dp(
        ConvVAE1D(**VAE_KW, bn_axis_name="data"), xv, xv[:VAE_BATCH],
        vae_trainer.TrainConfig(epochs=PAR_DP_EPOCHS, batch_size=VAE_BATCH,
                                lr=1e-3, loss_type="bce"), 0, dmesh)[1:])
    cls = refs["classes_data"]
    run("classes", lambda: sweep_dist.train_vae_classes_sharded(
        ConvVAE1D(**cls["arch"]), cls["x_cals"], cls["x_vals"],
        vae_trainer.TrainConfig(**cls["cfg"]), mmesh, seed=42)._replace(
            bundle=None, final_state=None, final_opt_state=None))
    models = simca_model_from_numpy(refs["models"], device=dev)
    raw_models = simca_model_from_numpy(refs["raw_models"], device=dev)
    x64 = serving_data()
    screens = {"f32": x64.astype(np.float32), "raw-u16": camera_counts(x64)}
    screens["bf16"] = screens["int8"] = screens["f32"]
    del x64
    for mode in SRV_MODES:
        kw = ({"preprocess_fn": prep_raw} if mode == "raw-u16" else
              {"store_dtype": {"f32": None, "bf16": torch.bfloat16,
                               "int8": torch.int8}[mode]})
        scorer = SIMCAScorer(raw_models if mode == "raw-u16" else models,
                             chunk_size=SRV_CHUNK, mesh=dmesh, **kw)
        run(f"screen_{mode}", lambda: scorer.score(screens[mode]))
    hpo = refs["hpo_data"]
    run("asha", lambda: {k: v for k, v in sweep.asha_vae_search(
        hpo["x_cal"], hpo["x_val"], HPO_SPACE, n_trials=HPO_TRIALS,
        max_epochs=HPO_EPOCHS, reduction=HPO_REDUCTION, seed=HPO_SEED,
        base_config=HPO_BASE, mesh=mmesh, verbose=False).items()
        if k in ("rungs", "total_epochs", "best_value", "trials")})
    return out


def parallel_rank(rank, world, init_file, refs, results):
    """One rank of phase 21's pass (b) (gloo, every rank on ``cuda:0``):
    its workloads' results, or its traceback, into ``results``."""
    import datetime
    import traceback

    import torch.distributed as dist

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        _build.library()
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
        try:
            out = parallel_workloads(torch.device("cuda", 0), refs, True)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "err", traceback.format_exc()))


def nccl_pass(dev, refs, tmp):
    """Pass (a): one process, a single-rank NCCL group on ``cuda:0`` (its
    collectives run through the group), the workload subset."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, 'nccl_store')}",
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    try:
        check(dist.get_backend() == "nccl", "pass (a) is not on NCCL")
        return [parallel_workloads(dev, refs, full=False)]
    finally:
        dist.destroy_process_group()


def start_gloo_pass(refs, tmp, world=2):
    """Pass (b): start ``world`` spawned gloo ranks sharing ``cuda:0`` with
    CUDA tensors, every workload; ``finish_gloo_pass`` collects them."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_file = os.path.join(tmp, "gloo_store")
    procs = [ctx.Process(target=parallel_rank,
                         args=(r, world, init_file, refs, results))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, results


def finish_gloo_pass(procs, results):
    """Pass (b)'s results, in rank order.  A rank that fails, dies or hangs
    fails the run; every rank process is stopped before this returns."""
    import queue

    outs, errors = [None] * len(procs), []
    try:
        for _ in procs:
            try:
                rank, status, value = results.get(timeout=PAR_TIMEOUT_S)
            except queue.Empty:
                raise SystemExit("chip_smoke: FAILED: phase 21: a gloo rank "
                                 f"gave no answer within {PAR_TIMEOUT_S} s")
            if status == "err":
                errors.append(f"rank {rank}: {value}")
            outs[rank] = value
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    check(not errors, "phase 21 (b): " + "\n".join(errors))
    check(all(p.exitcode == 0 for p in procs),
          f"phase 21 (b): rank exit codes {[p.exitcode for p in procs]}")
    return outs


def parallel_refs(dev):
    """The local (unsharded) references of phase 21, on the card, and the
    inputs its ranks take from the parent (fitted models, split data)."""
    cals, _ = make_data()
    labels = np.repeat(np.arange(N_CLASSES), N_CAL)
    cal64 = cals.reshape(-1, LENGTH)
    models = fit_classes(cal64.astype(np.float32), labels,
                         list(range(N_CLASSES)), K, solver="rsvd")
    raw_models = fit_classes(
        prep_raw(torch.as_tensor(camera_counts(cal64), device=dev)
                 .to(torch.float32)), labels, list(range(N_CLASSES)), K,
        solver="rsvd")
    data = synthetic.nut_objects(seed=42)
    names = list(data)
    length = data[names[0]][0].shape[1]
    sps = [splits.object_aware_splits(data, names, nut, length,
                                      verbose=False) for nut in names]
    nuts = synthetic.nut_objects()
    hpo = splits.object_aware_splits(nuts, list(nuts), "peanut",
                                     nuts["peanut"][0].shape[1],
                                     verbose=False)
    from ocm_tpu_torch.models.simca import simca_model_to_numpy

    refs = {"models": simca_model_to_numpy(models),
            "raw_models": simca_model_to_numpy(raw_models),
            "classes_data": {
                "arch": dict(input_length=length, latent_dim=6,
                             conv_blocks=2, n_filters=16, hidden_fc=64),
                "cfg": dict(epochs=8, batch_size=64, lr=1e-3,
                            loss_type="euclidean"),
                "x_cals": [np.asarray(s.x_cal) for s in sps],
                "x_vals": [np.asarray(s.x_val) for s in sps]},
            "hpo_data": {"x_cal": np.asarray(hpo.x_cal),
                         "x_val": np.asarray(hpo.x_val),
                         "cal": hpo.x_cal.shape[0]}}
    return refs, models, raw_models


def parallel_local(dev, refs, models, raw_models):
    """The local (unsharded) paths of phase 21's workloads on the card, the
    references its ranks are held to."""
    from ocm_tpu_torch.models.simca import simca_decide

    loc = {}
    cals, xs = make_data()
    x0 = cals[0].astype(np.float32)
    loc["xs32"] = torch.as_tensor(xs.astype(np.float32), device=dev)
    del xs
    loc["fit"] = {s: fit_simca_masked(torch.as_tensor(x0, device=dev),
                                      torch.ones(len(x0), device=dev), K,
                                      solver=s) for s in ("rsvd", "eigh")}
    loc["accept"] = {s: simca_decide(m, loc["xs32"])[0].cpu().numpy()
                     for s, m in loc["fit"].items()}
    xcv, ycv = cv_data()
    loc["cv"] = cv.cv_simca_sweep(xcv, ycv, 0, CV_LVS, n_splits=CV_FOLDS,
                                  solver="rsvd")
    loc["cv_multiclass"] = cv.cv_simca_sweep_multiclass(
        xcv, ycv, [0, 1], CV_LVS, n_splits=CV_FOLDS, solver="rsvd")
    loc["sweep"] = batched_sweep(epochs=SWEEP_EPOCHS)
    cls = refs["classes_data"]
    loc["classes"] = sweep.train_vae_classes(
        ConvVAE1D(**cls["arch"]), cls["x_cals"], cls["x_vals"],
        vae_trainer.TrainConfig(**cls["cfg"]), seed=42)
    x64 = serving_data()
    loc["screen"] = {mode: s.score(camera_counts(x64) if mode == "raw-u16"
                                   else x64.astype(np.float32))
                     for mode, s in make_serving_scorers(
                         models, raw_models).items()}
    del x64
    order = np.random.default_rng(7).permutation(N_CLASSES * N_CAL)
    labels = np.repeat(np.arange(N_CLASSES), N_CAL)
    cal32 = cals.reshape(-1, LENGTH).astype(np.float32)
    mom = streaming.moments_init(LENGTH, device=dev)
    for i in range(0, len(order), SRV_BATCH):
        idx = order[i:i + SRV_BATCH]
        mom = streaming.moments_update(
            mom, cal32[idx], w=(labels[idx] == 0).astype(np.float32))
    loc["moments"] = mom
    torch.cuda.synchronize()
    return loc


def parallel_checks(dev, refs, loc, passes):
    """Every rank's results of both passes against the local paths on the
    card (``parallel_local``), and pass (a) against pass (b); returns the
    checks' numbers."""
    from ocm_tpu_torch.models.simca import simca_decide, simca_model_from_numpy

    nums = {}
    xs32, local, acc_local = loc["xs32"], loc["fit"], loc["accept"]
    cv_local, cv_multi_local = loc["cv"], loc["cv_multiclass"]
    sweep_local, classes_local = loc["sweep"], loc["classes"]
    screen_local, mom_local = loc["screen"], loc["moments"]
    cls = refs["classes_data"]

    def lims(tree):
        return np.array([float(tree["t2_res"]["limit"]),
                         float(tree["q_res"]["limit"]),
                         float(tree["d_limit"])])

    steps = -(-SWEEP_CAL // VAE_BATCH)
    worst = dict.fromkeys(("fit_limit_rel", "fit_accept_agree_min",
                           "predict_dred_rel", "moments_rel", "cv_pp",
                           "dp_loss_rel", "dp_grad_rel", "sweep_train",
                           "sweep_val", "classes_train", "classes_val"),
                          0.0)
    worst["fit_accept_agree_min"] = 1.0
    for label, ranks in passes.items():
        world = len(ranks)
        for rank, out in enumerate(ranks):
            where = f"phase 21 ({label}) rank {rank}"
            for solver in ("rsvd", "eigh"):
                if f"fit_{solver}" not in out:
                    continue
                tree = out[f"fit_{solver}"][0]
                ref = local[solver]
                ref_l = np.array([float(ref.t2_res.limit),
                                  float(ref.q_res.limit),
                                  float(ref.d_limit)])
                rel = float(np.max(np.abs(lims(tree) - ref_l)
                                   / np.abs(ref_l)))
                check(rel <= 1e-4, f"{where}: {solver} fit limits {rel}")
                sharded = simca_model_from_numpy(tree, device=dev)
                agree = float((simca_decide(sharded, xs32)[0].cpu().numpy()
                               == acc_local[solver]).mean())
                check(agree >= 0.999, f"{where}: {solver} accepts {agree}")
                worst["fit_limit_rel"] = max(worst["fit_limit_rel"], rel)
                worst["fit_accept_agree_min"] = min(
                    worst["fit_accept_agree_min"], agree)
            # the sharded screen against local simca_decide of its rows
            (acc, dred, _, _), counts, _ = out["predict"]
            rows = slice(rank * N_SCORE // world,
                         (rank + 1) * N_SCORE // world)
            sharded = simca_model_from_numpy(out["fit_rsvd"][0], device=dev)
            acc_r, dred_r, _, _ = simca_decide(sharded, xs32[rows])
            check(np.array_equal(acc, acc_r.cpu().numpy()),
                  f"{where}: predict_sharded accepts differ")
            rel = float(np.max(np.abs(dred - dred_r.cpu().numpy())
                               / np.abs(dred_r.cpu().numpy())))
            check(rel <= 1e-5, f"{where}: predict_sharded dred {rel}")
            check(counts["t2q_scores_multiclass"] == 1 and only(
                counts, t2q_scores_multiclass=1),
                f"{where}: predict_sharded launches {counts}")
            worst["predict_dred_rel"] = max(worst["predict_dred_rel"], rel)
            # the data-parallel step against the single-process step
            (loss_rel, grad_rel), step_counts, _ = out["dp_step"]
            check(loss_rel <= 1e-5 and grad_rel <= 1e-4,
                  f"{where}: DP step loss {loss_rel}, gradients {grad_rel}")
            check(only(step_counts, reparam_kl=1, reparam_kl_bwd=1),
                  f"{where}: DP step launches {step_counts}")
            worst["dp_loss_rel"] = max(worst["dp_loss_rel"], loss_rel)
            worst["dp_grad_rel"] = max(worst["dp_grad_rel"], grad_rel)
            # the 8-config sweep: each rank one stacked run of its slice
            res, counts, _ = out["sweep"]
            check(only(counts, **stacked_launches(6, steps, SWEEP_EPOCHS)),
                  f"{where}: sharded sweep launches {counts}")
            tl = finite_rel(res[1], sweep_local.train_losses)
            vl = finite_rel(res[2], sweep_local.val_losses)
            check(tl <= 1e-5 and vl <= 2e-3 and np.array_equal(
                res[3], sweep_local.best_epoch),
                f"{where}: sharded sweep train {tl}, val {vl}, best "
                f"{res[3]} vs {sweep_local.best_epoch}")
            worst["sweep_train"] = max(worst["sweep_train"], float(tl))
            worst["sweep_val"] = max(worst["sweep_val"], float(vl))
            if "moments" not in out:
                continue
            mom, _, _ = out["moments"]
            scale = float(mom_local.scatter.abs().max())
            rel = max(float(np.max(np.abs(mom.scatter - mom_local.scatter
                                          .cpu().numpy()))) / scale,
                      float(np.max(np.abs(mom.mean - mom_local.mean.cpu()
                                          .numpy()))) /
                      float(mom_local.mean.abs().max()),
                      abs(float(mom.n) - float(mom_local.n)))
            check(rel <= 1e-5, f"{where}: sharded moments {rel}")
            worst["moments_rel"] = max(worst["moments_rel"], rel)
            for name, ref in (("cv", cv_local), ("cv_2d", cv_local),
                              ("cv_multiclass", cv_multi_local)):
                got = out[name][0]
                pp = max(float(np.max(np.abs(got[k] - ref[k])))
                         for k in ("sens", "spec"))
                same = np.array_equal(np.argmax(got["eff"], -1),
                                      np.argmax(ref["eff"], -1))
                check(pp <= 0.5 and same, f"{where}: {name} {pp} pp, best "
                      f"LV {np.argmax(got['eff'], -1)} vs "
                      f"{np.argmax(ref['eff'], -1)}")
                worst["cv_pp"] = max(worst["cv_pp"], pp)
            (tl, vl, best), counts, _ = out["train_vae_dp"]
            steps_dp = VAE_N // VAE_BATCH
            check(bool(np.isfinite(tl).all() and np.isfinite(vl).all())
                  and tl[-1] < tl[0], f"{where}: train_vae_dp losses {tl}")
            check(only(counts, reparam_kl=(steps_dp + 1) * PAR_DP_EPOCHS,
                       reparam_kl_bwd=steps_dp * PAR_DP_EPOCHS),
                  f"{where}: train_vae_dp launches {counts}")
            res, counts, _ = out["classes"]
            n_max = max(len(x) for x in cls["x_cals"])
            check(only(counts, **stacked_launches(
                4, -(-n_max // cls["cfg"]["batch_size"]),
                cls["cfg"]["epochs"])), f"{where}: classes launches {counts}")
            tl = finite_rel(res[1], classes_local.train_losses)
            vl = finite_rel(res[2], classes_local.val_losses)
            check(tl <= 1e-5 and vl <= 2e-3 and np.array_equal(
                res[3], classes_local.best_epoch),
                f"{where}: sharded classes train {tl}, val {vl}")
            worst["classes_train"] = max(worst["classes_train"], float(tl))
            worst["classes_val"] = max(worst["classes_val"], float(vl))
            for mode in SRV_MODES:
                got, counts, _ = out[f"screen_{mode}"]
                ref = screen_local[mode]
                check(np.array_equal(got["accept"], ref["accept"]),
                      f"{where}: sharded {mode} screen accepts differ")
                rel = max(float(np.max(np.abs(got[k] - ref[k])))
                          / float(np.max(np.abs(ref[k])))
                          for k in ("dred", "t2", "q"))
                # bit-equal where the same kernel computes each row; within
                # 1e-6 of scale otherwise (PERF.md says which and why)
                check(rel <= 1e-6,
                      f"{where}: sharded {mode} statistics differ by {rel}")
                key = f"screen_{mode}_stats_rel"
                nums[key] = max(nums.get(key, 0.0), rel)
                want = {"f32": {"t2q_scores_multiclass": 2},
                        "raw-u16": {"t2q_scores_multiclass": 2},
                        "bf16": {"t2q_scores_multiclass_bf16": 2},
                        "int8": {"int8_gemm_s32": 2}}[mode]
                check(only(counts, **want),
                      f"{where}: sharded {mode} launches {counts}")
            res, counts, _ = out["asha"]
            rungs, total = asha_schedule(HPO_TRIALS, HPO_EPOCHS,
                                         HPO_REDUCTION)
            check(res["rungs"] == rungs and res["total_epochs"] == total
                  and np.isfinite(res["best_value"]),
                  f"{where}: sharded ASHA {res['rungs']} "
                  f"{res['total_epochs']} {res['best_value']}")
            hpo_steps = -(-refs["hpo_data"]["cal"] // HPO_BASE["batch_size"])
            want = halving_k2(res["trials"], res["rungs"], hpo_steps)
            check(counts["bn_act_fwd"] == want == counts["bn_act_bwd"],
                  f"{where}: sharded ASHA K2/K3 {counts} != {want}")
    # pass (a) against pass (b)
    a, b = passes["a"][0], passes["b"][0]
    rel = float(np.max(np.abs(lims(a["fit_rsvd"][0]) - lims(b["fit_rsvd"][0]))
                       / np.abs(lims(b["fit_rsvd"][0]))))
    check(rel <= 1e-4, f"phase 21: NCCL and gloo fits differ by {rel}")
    check(np.array_equal(a["sweep"][0][3], b["sweep"][0][3]),
          "phase 21: NCCL and gloo sweeps' best epochs differ")
    nums["nccl_vs_gloo_fit_rel"] = rel
    nums.update(worst)
    return nums


def parallel_phases(dev, card):
    """Phase 21, the sharded paths of ``ocm_tpu_torch.parallel`` on the
    card: pass (a) on a single-rank NCCL group in this process, pass (b) on
    two gloo ranks sharing ``cuda:0``, each held to the local paths.
    Returns {kernel record: launches of both passes, every rank}."""
    t_phase = time.perf_counter()
    refs, models, raw_models = parallel_refs(dev)
    with tempfile.TemporaryDirectory() as tmp:
        # pass (b)'s ranks work while this process runs pass (a) and the
        # local paths: three processes share the card and the host
        t_b = time.perf_counter()
        procs, results = start_gloo_pass(refs, tmp)
        passes = {}
        try:
            t0 = time.perf_counter()
            passes["a"] = nccl_pass(dev, refs, tmp)
            a_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loc = parallel_local(dev, refs, models, raw_models)
            local_s = time.perf_counter() - t0
        finally:
            passes["b"] = finish_gloo_pass(procs, results)
        b_s = time.perf_counter() - t_b
    nums = parallel_checks(dev, refs, loc, passes)
    launches = {}
    for ranks in passes.values():
        for out in ranks:
            for _, counts, _ in out.values():
                for k, n in counts.items():
                    launches[k] = launches.get(k, 0) + n
    host_ms = {label: [{name: ms for name, (_, _, ms) in out.items()}
                       for out in ranks] for label, ranks in passes.items()}
    print(json.dumps({"phase": "parallel", "card": card,
                      "passes": {"a": "nccl, 1 rank", "b": "gloo, 2 ranks "
                                 "sharing cuda:0, CUDA tensors"},
                      "pass_s": {"a": a_s, "b": b_s, "local": local_s},
                      "host_ms": host_ms,
                      "launches": launches, **nums}), flush=True)
    print(f"phase 21 seconds: {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return launches


# --- the eval-mode conv epilogue (K9) ---------------------------------------

def eval_operands(shape, gen, dev):
    """x (B, C, L) and the epilogue's (C,) vectors: conv bias, running mean
    and var, gamma, beta."""
    nc = shape[1]
    x = torch.randn(shape, generator=gen).to(dev)
    bias, mean, beta = ((0.3 * torch.randn(nc, generator=gen)).to(dev)
                        for _ in range(3))
    var = (torch.rand(nc, generator=gen) + 0.5).to(dev)
    gamma = (0.5 * torch.rand(nc, generator=gen) + 0.5).to(dev)
    return x, bias, mean, var, gamma, beta


def eval_block_shapes(kw, batch):
    """The (B, C, L) of each eval conv block's activation (the conv's output
    before its ``BatchNormAct``) of a ``ConvVAE1D(**kw)`` at ``batch``
    spectra, encoder then decoder."""
    model, shapes = ConvVAE1D(**kw).eval(), []
    for seq in (model.encoder_conv, model.decoder_conv):
        mods = list(seq)
        for mod, nxt in zip(mods, mods[1:]):
            if isinstance(nxt, BatchNormAct):
                mod.register_forward_hook(lambda m, a, o: shapes.append(
                    (batch, *o.shape[1:])))
    with torch.no_grad():
        model.decode(model.encode(torch.zeros(1, kw["input_length"]))[0])
    return shapes


def check_bn_eval(shape, gen, dev):
    """K9 against the eager chain at ``shape``, in place, for each
    activation: the same bits with ELU and none, within 2 ulp with exact
    GELU.  Returns the largest absolute difference."""
    err = 0.0
    x, bias, mean, var, gamma, beta = eval_operands(shape, gen, dev)
    for act in bn.ACTS:
        ref = bn.bn_act_eval_plain(x, bias, mean, var, gamma, beta, BN_EPS,
                                   act)
        got = bn.bn_act_eval(x.clone(), bias, mean, var, gamma, beta, BN_EPS,
                             act)
        ulps = int((got.view(torch.int32).long()
                    - ref.view(torch.int32).long()).abs().max())
        err = max(err, float((got - ref).abs().max()))
        check(ulps <= (2 if act == "gelu" else 0),
              f"K9 ({act}) at {shape} is {ulps} ulp from the eager chain")
        del got, ref
    return err


def time_bn_eval(dev, bw, f32_rate, gen=None):
    """K9 at ``EVAL_SHAPES``, in place as a screen runs it: its device ms,
    its bound (8 bytes an element), the chain's ms (``plain_ms``: the conv
    bias add, then ``bn_act_normalize``'s three passes and ELU) and one
    call's ms with its wrapper (``bn_act_eval``: ``mul``, then the launch);
    the three summed under ``total``.  Each activation (604 MB) is far
    past the L2.  First ``check_bn_eval`` at those shapes and at the entry
    model's activations at ``DEC_CHUNK`` (L 501, 251, 126, 252, 504: the
    4-, 8- and 16-byte vector builds); ``max_abs_err`` is the largest
    difference it found."""
    gen = gen or torch.Generator().manual_seed(22)
    err = max(check_bn_eval(shape, gen, dev) for shape in
              dict.fromkeys((*EVAL_SHAPES,
                             *eval_block_shapes(VAE_KW, DEC_CHUNK))))
    rows, tot = [], dict.fromkeys(("ms", "plain_ms", "bound_ms", "call_ms"),
                                  0.0)
    for shape in EVAL_SHAPES:
        x, bias, mean, var, gamma, beta = eval_operands(shape, gen, dev)
        mul = torch.rsqrt(var + BN_EPS) * gamma
        n = x.numel()
        row = {"shape": list(shape),
               "ms": device_ms(lambda: bn.bn_act_eval_fused(
                   x, bias, mean, mul, beta, "elu"), 20),
               "plain_ms": device_ms(lambda: bn.bn_act_eval_plain(
                   x, bias, mean, var, gamma, beta, BN_EPS, "elu"), 10),
               "call_ms": median_ms(lambda: bn.bn_act_eval(
                   x, bias, mean, var, gamma, beta, BN_EPS, "elu"), 3, 11),
               **bound_of(8 * n + 16 * shape[1], K9_OPS * n, bw, f32_rate)}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(json.dumps({"phase": "bn_eval_timing", **row}), flush=True)
        rows.append(row)
        for key in tot:
            tot[key] += row[key]
        del x
    return {"shapes": rows, "total": tot, "max_abs_err": err}


def nuts_eval_scorers(dev, gen):
    """One nuts-width class (random weights and BatchNorm statistics),
    calibrated on 512 spectra: its ``vaesimca`` and ``d2`` scorers at
    chunk 16,384, and K9's launches in their calibrations."""
    model = ConvVAE1D(**NUTS_KW)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_var"):
            v = torch.rand(v.shape, generator=gen) + 0.5
        elif v.dtype == torch.float32 and not k.endswith("weight"):
            v = v + 0.2 * torch.randn(v.shape, generator=gen)
        sd[k] = v.to(dev)
    x_cal = torch.randn(512, NUTS_KW["input_length"], generator=gen).to(dev)
    mean, std = vae_bundle.spectral_stats(x_cal)
    bundle = vae_bundle.new_bundle(sd, mean, std, NUTS_KW["latent_dim"])
    before = bn.bn_act_eval.launches
    vs = vaesimca.fit_vaesimca(model, bundle, x_cal)
    d2_bundle = vae_decision.fit_thresholds(model, bundle, x_cal)
    torch.cuda.synchronize()
    calibration = bn.bn_act_eval.launches - before
    return ({"vaesimca": VAEScorer(model, bundle, variant="vaesimca",
                                   chunk_size=EVAL_CHUNK, vaesimca_model=vs),
             "d2": VAEScorer(model, d2_bundle, variant="d2",
                             chunk_size=EVAL_CHUNK)}, calibration)


def bn_eval_phases(dev, card, bw, f32_rate):
    """Phase 22: K9 timed at the nuts activations (``time_bn_eval``), and
    nuts-width screens of 32,768 spectra with their K9 launches, counters
    and answers against the plain path.  Returns K9's kernel record."""
    timing = time_bn_eval(dev, bw, f32_rate)
    gen = torch.Generator().manual_seed(23)
    scorers, calibration = nuts_eval_scorers(dev, gen)
    x = torch.randn(2 * EVAL_CHUNK, NUTS_KW["input_length"],
                    generator=gen).numpy()
    launches, counts = {}, {}
    for label, scorer in scorers.items():
        scorer.score(x)
        torch.cuda.synchronize()
        profiling.reset()
        before = bn.bn_act_eval.launches
        with profiling.tracing():
            fused = scorer.score(x)
        torch.cuda.synchronize()
        launches[label] = bn.bn_act_eval.launches - before
        c = profiling.counters()
        counts[label] = [c.get("model.bn_act_eval_fused", 0),
                         c.get("model.bn_act_eval_plain", 0)]
        profiling.reset()
        applies, bn.eval_kernel_applies = bn.eval_kernel_applies, \
            lambda *a: False
        try:
            plain = scorer.score(x)
        finally:
            bn.eval_kernel_applies = applies
        check(fused.keys() == plain.keys() and all(
            np.array_equal(fused[k], plain[k]) for k in fused),
            f"{label}: the screen on K9 differs from the plain path")
    want = {"vaesimca": 2 * 9, "d2": 2 * 3}
    print(json.dumps({"phase": "bn_eval_screens", "card": card,
                      "spectra": 2 * EVAL_CHUNK, "chunk": EVAL_CHUNK,
                      "k9_launches": launches, "fused_plain_counts": counts,
                      "k9_launches_calibration": calibration,
                      "timing_total": timing["total"]}), flush=True)
    check(launches == want, f"K9 launches {launches}, expected {want}")
    check(counts == {k: [v, 0] for k, v in want.items()},
          f"K9 counters {counts}")
    check(all(math.isfinite(r["ms"]) and r["ms"] > 0
              for r in timing["shapes"]), "a K9 timing is not finite")
    tot = timing["total"]
    return {"name": "bn_act_eval", "route": "cuda",
            "source": "ocm_tpu_torch/csrc/bn_act.cu",
            "replaces": "the eager eval-mode conv epilogue of "
                        "ocm_tpu_torch/models/vae.py (no TPU kernel)",
            "launches": sum(launches.values()) + calibration,
            "max_abs_err": timing["max_abs_err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes", "library_ms": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-times", action="store_true",
                    help="time the kernels only (see kernel_times)")
    ap.add_argument("--bn-eval", action="store_true",
                    help="the build and phase 22 (K9) only")
    args = ap.parse_args(argv)
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
                      "cudnn_deterministic":
                          torch.backends.cudnn.deterministic,
                      "float32_matmul_precision":
                          torch.get_float32_matmul_precision()}), flush=True)
    check(torch.backends.cudnn.deterministic,
          "loading ocm_tpu_torch did not select cuDNN's deterministic mode")
    if args.kernel_times:
        kernel_times(dev, card, name)
        return 0

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.library()                  # the host C++ core, g++ (phase 18)
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "library": _build.library_path().name,
                      "native_seconds": time.perf_counter() - t0,
                      "native_library": native.library_path().name}),
          flush=True)
    for line in resource_report(_build.build_logs()):
        print(line, flush=True)
    if args.bn_eval:
        bw, f32_rate, _ = peaks(name)
        record = bn_eval_phases(dev, card, bw, f32_rate)
        print(json.dumps({"kernels": [record]}), flush=True)
        print(card, flush=True)
        return 0
    sass_report()

    cals, xs = make_data()
    cals32 = cals.astype(np.float32)
    xs32 = xs.astype(np.float32)
    x_dev = torch.as_tensor(xs32, device=dev)
    cals_dev = torch.as_tensor(cals32, device=dev)

    # 3. kernel vs plain twin: bench shapes (models resident), a ragged
    #    single class, models staged a pass at a time (C 5, k 12, L 2000)
    #    and over windows of L with several warps a CTA (L 3000), and k > 32
    #    (two tasks a class) with L not a multiple of 4
    models = fit_simca(cals_dev, K, solver="rsvd")
    bench_err = compare_kernel("bench N=98304 L=500 C=3 k=10", x_dev, models)
    rc, _ = make_data(seed=1, n_cal=200, length=96, n_classes=1, n_score=1)
    small = fit_simca(torch.as_tensor(rc[:1], dtype=torch.float32, device=dev),
                      8, solver="rsvd")
    compare_kernel("ragged N=137 L=96 C=1 k=8",
                   torch.as_tensor(rc[0, :137], dtype=torch.float32, device=dev),
                   small)
    gen = torch.Generator().manual_seed(0)
    for n, length, c, k in ((1000, 2000, 5, 12), (20000, 3000, 3, 12),
                            (300, 203, 2, 40)):
        compare_kernel(f"N={n} L={length} C={c} k={k}",
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
    call_ms = median_ms(lambda: kernels.t2q_scores_multiclass(*args),
                        warmup=3, reps=21)
    kernel_ms = device_ms(lambda: kernels.t2q_scores_multiclass(*args), 20)
    plain_ms = device_ms(lambda: kernels.t2q_scores_multiclass_plain(*args),
                         10)
    library_ms = device_ms(lambda: library_scores(*args), 10)
    bw, f32_rate, int8_rate = peaks(name)
    nbytes, flops = k1_work(N_SCORE, LENGTH, N_CLASSES, K, 4)
    bytes_ms, flops_ms = 1e3 * nbytes / bw, 1e3 * flops / f32_rate
    bound_ms = max(bytes_ms, flops_ms)
    print(json.dumps({"phase": "timings", "card": card, "fit_ms": fit_ms,
                      "t2_limit_ms": t2_limit_ms,
                      "predict_ms": predict_ms, "kernel_ms": kernel_ms,
                      "kernel_call_ms": call_ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_bytes_ms": bytes_ms, "bound_flops_ms": flops_ms,
                      "kernel_share_of_bound": bound_ms / kernel_ms,
                      "build_s": build_s}), flush=True)

    records = [{"name": "t2q_scores_multiclass", "route": "cuda",
              "source": "ocm_tpu_torch/csrc/t2q_scores.cu",
              "replaces": "ocm_tpu/ops/kernels.py:45", "launches": launches,
              "max_abs_err": bench_err, "ms": kernel_ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms,
              "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
              "library_ms": library_ms}]
    check(all(math.isfinite(v) for v in (kernel_ms, plain_ms, library_ms)),
          "a timing is not finite")

    # 6. the VAE kernels against their plain twins at the path's shapes
    shapes = path_bn_shapes(dev)
    check(shapes == TRAIN_BN_SHAPES,
          f"BatchNorm shapes {shapes} != {TRAIN_BN_SHAPES}")
    gen = torch.Generator().manual_seed(0)
    k2_err = k3_err = 0.0
    for shape, act in [(sh, "elu") for sh in shapes] + [
            (shapes[0], "gelu"), (shapes[0], "none")]:
        e2, e3 = compare_bn(shape, act, gen, dev)
        k2_err, k3_err = max(k2_err, e2), max(k3_err, e3)
    # K4 and K6's backward: the train batch, odd k, one element, ragged k
    # above 32, a long batch, k past 128; then mu one float off alignment
    reparam_errs = [compare_reparam(sh, gen, dev) for sh in REPARAM_SHAPES]
    reparam_errs += [compare_reparam(sh, gen, dev, mu_offset=1)
                     for sh in ((VAE_BATCH, VAE_KW["latent_dim"]), (1000, 64))]
    chained_err = compare_after_linear(gen, dev)
    k4_err = max(chained_err, *(e[0] for e in reparam_errs))
    k6_err = max(chained_err, *(e[1] for e in reparam_errs))

    # 7. the VAE main path, as a user calls it, with the launch counts read
    x_vae = vae_workload()
    cfg = vae_trainer.TrainConfig(epochs=VAE_EPOCHS, batch_size=VAE_BATCH,
                                  lr=1e-3, loss_type="bce")
    bn.bn_act_fwd.launches = bn.bn_act_bwd.launches = 0
    kernels.reparam_kl.launches = kernels.reparam_kl_bwd.launches = 0
    result = vae_trainer.train_vae(ConvVAE1D(**VAE_KW), x_vae,
                                   x_vae[:VAE_BATCH], cfg, seed=0)
    torch.cuda.synchronize()
    vae_launches = {"bn_act_fwd": bn.bn_act_fwd.launches,
                    "bn_act_bwd": bn.bn_act_bwd.launches,
                    "reparam_kl": kernels.reparam_kl.launches,
                    "reparam_kl_bwd": kernels.reparam_kl_bwd.launches}
    tl, vl = result.train_losses, result.val_losses
    print(json.dumps({"phase": "vae_main_path", "launches": vae_launches,
                      "train_losses": tl.tolist(), "val_losses": vl.tolist(),
                      "best_epoch": result.best_epoch}), flush=True)
    steps = VAE_EPOCHS * -(-VAE_N // VAE_BATCH)
    check(vae_launches == {"bn_act_fwd": 6 * steps, "bn_act_bwd": 6 * steps,
                           "reparam_kl": steps + VAE_EPOCHS,
                           "reparam_kl_bwd": steps},
          f"VAE launch counts {vae_launches}")
    check(bool(np.isfinite(tl).all() and np.isfinite(vl).all()),
          "a VAE loss is not finite")
    check(tl[-1] < tl[0], f"train loss did not fall: {tl[0]} -> {tl[-1]}")
    step_vs_cpu_f64(cfg, x_vae, dev)
    entry_forward_vs_cpu_f64(dev)

    # 8. VAE timings
    model = ConvVAE1D(**VAE_KW).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    step = vae_trainer.make_train_step(model, opt, cfg)
    xb = torch.as_tensor(x_vae[:VAE_BATCH], device=dev)
    eps = torch.randn(VAE_BATCH, VAE_KW["latent_dim"], generator=gen).to(dev)
    train_step_ms = median_ms(lambda: step(xb, eps), 3, 21)
    breakdown(lambda: step(xb, eps))
    t0 = time.perf_counter()
    vae_trainer.train_vae(ConvVAE1D(**VAE_KW), x_vae, x_vae[:VAE_BATCH], cfg,
                          seed=0)
    torch.cuda.synchronize()
    train_vae_ms = 1e3 * (time.perf_counter() - t0)
    bn_t, bn_bound_by = time_bn(shapes, gen, dev, bw, f32_rate)
    rt = time_reparam_train(dev, gen, bw, f32_rate)
    print(json.dumps({"phase": "vae_timings", "card": card,
                      "train_step_ms": train_step_ms,
                      "train_vae_ms": train_vae_ms,
                      "steps": steps, **bn_t,
                      **{key: rt[key] for key in rt if key != "shape"}}),
          flush=True)
    records += [
        {"name": "bn_act_fwd", "route": "cuda",
         "source": "ocm_tpu_torch/csrc/bn_act.cu",
         "replaces": "ocm_tpu/ops/bn.py:126",
         "launches": vae_launches["bn_act_fwd"], "max_abs_err": k2_err,
         "ms": bn_t["k2_ms"], "plain_ms": bn_t["k2_plain_ms"],
         "bound_ms": bn_t["k2_bound_ms"], "bound_by": bn_bound_by["k2"],
         "library_ms": bn_t["k2_library_ms"]},
        {"name": "bn_act_bwd", "route": "cuda",
         "source": "ocm_tpu_torch/csrc/bn_act.cu",
         "replaces": "ocm_tpu/ops/bn.py:147",
         "launches": vae_launches["bn_act_bwd"], "max_abs_err": k3_err,
         "ms": bn_t["k3_ms"], "plain_ms": bn_t["k3_plain_ms"],
         "bound_ms": bn_t["k3_bound_ms"], "bound_by": bn_bound_by["k3"],
         "library_ms": bn_t["k3_library_ms"]},
        {"name": "reparam_kl", "route": "cuda",
         "source": "ocm_tpu_torch/csrc/reparam_kl.cu",
         "replaces": "ocm_tpu/ops/kernels.py:110",
         "launches": vae_launches["reparam_kl"], "max_abs_err": k4_err,
         **{f: rt[f"k4_{f}"] for f in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}},
        {"name": "reparam_kl_bwd", "route": "cuda",
         "source": "ocm_tpu_torch/csrc/reparam_kl.cu",
         "replaces": "ocm_tpu/ops/kernels.py:192",
         "launches": vae_launches["reparam_kl_bwd"], "max_abs_err": k6_err,
         **{f: rt[f"k6_bwd_{f}"] for f in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}}]
    check(all(math.isfinite(v) for v in (
        train_step_ms, train_vae_ms, *bn_t.values(), rt["launch_floor_ms"],
        rt["k4_ms"], rt["k6_bwd_ms"], rt["k6_bwd_plain_ms"],
        rt["fc_logvar_then_k4_ms"])), "a VAE timing is not finite")

    k5_record, decisions = decision_phases(dev, card, bw, f32_rate)
    records.append(k5_record)
    records += serving_phases(dev, card, (bw, f32_rate, int8_rate), decisions)
    # 17. the CV slice; K1's launches on the main path include its own
    records[0]["launches"] += cv_phases(dev, card, decisions)
    # 18. the data layer; its launches count into the records of its kernels
    for kernel, n in data_layer_phases(dev, card).items():
        next(r for r in records if r["name"] == kernel)["launches"] += n
    # 19. HPO and sweeps; its launches and its kernels' errors at the
    #     stacked shapes go into their records
    launches, errs = sweep_phases(dev, card, torch.Generator().manual_seed(19))
    for kernel, n in launches.items():
        rec = next(r for r in records if r["name"] == kernel)
        rec["launches"] += n
        rec["max_abs_err"] = max(rec["max_abs_err"], errs[kernel])
    # 20. the front doors: F1, the CLI, the server; its launches and its
    #     kernels' errors at the screens' operands go into their records
    launches, errs = front_door_phases(dev, card)
    for kernel, n in launches.items():
        next(r for r in records if r["name"] == kernel)["launches"] += n
    for kernel, e in errs.items():
        rec = next(r for r in records if r["name"] == kernel)
        rec["max_abs_err"] = max(rec["max_abs_err"], e)
    # 21. the sharded paths; their launches, every rank's, go into the
    #     records of their kernels
    for kernel, n in parallel_phases(dev, card).items():
        next(r for r in records if r["name"] == kernel)["launches"] += n
    # 22. the eval-mode conv epilogue K9 at the nuts screens' widths
    records.append(bn_eval_phases(dev, card, bw, f32_rate))
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
