"""Command-line interface: ``python -m ocm_tpu_torch <command>`` (port of
``ocm_tpu/cli.py``).

One typed-flag entry point per workflow, each writing a run directory
(``params.json`` / ``metrics.json`` / ``losses.json`` and the deployable
model files).  The model files are the JAX package's (``utils.msgpack_io``),
so a run directory written by either package is read by the other's
``screen`` and ``serve``.

Commands
--------
- ``info``          torch / CUDA / cuDNN / card report
- ``simca``         classical SIMCA fit + evaluate
- ``cv``            fold x LV cross-validation sweep
- ``train-vae``     train ConvVAE1D + fit decision thresholds
- ``screen``        chunked scoring of a saved model over a dataset
- ``hpo``           TPE / ASHA / BOHB hyperparameter search
- ``ingest``        HSI cube -> HDF5 object store
- ``export-torch``  bundle -> reference-format .pth
- ``stream-update`` ingest a dataset chunk into a persisted streaming
                    statistic
- ``stream-fit``    fit a servable SIMCA model dir from the statistic
- ``plsda``         multi-class PLS-DA baseline
- ``serve``         resident HTTP scoring server (``server.py``)

Every data-consuming command takes ``--data file.npz|file.mat|file.h5`` or
falls back to the synthetic datasets (``--synthetic cheese|nuts``).  The
commands run on the CUDA card unless ``--platform cpu`` is given, before
or after the subcommand; with no card they raise and never fall back to
the CPU.  Float64 data (the synthetic sets, ``.mat`` files) runs in
float32 on the card and in float64 on the CPU (``config.stats_dtype``).
scipy (``.mat``), h5py (``.h5``, ``ingest``) and matplotlib (``--plots``)
load only in the commands that use them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

SIMCA_MODEL_FILE = "simca_model.msgpack"
SIMCA_META_JSON = "simca_meta.json"
BUNDLE_FILE = "model_bundle.msgpack"
VAESIMCA_FILE = "vaesimca_model.msgpack"
VARIANTS = ("d2", "d2_q", "f", "full", "vaesimca")


# ---------------------------------------------------------------- data


def _add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data", default=None,
                   help=".npz (x_train/y_train/x_test/y_test or x/y), "
                        "cheese-format .mat, or an `ingest` .h5 object "
                        "store (object-level split); default: synthetic")
    p.add_argument("--synthetic", default="cheese",
                   choices=["cheese", "nuts"],
                   help="synthetic dataset family when --data is absent")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--snv", action="store_true",
                   help="apply SNV row-normalization")
    p.add_argument("--savgol", default=None, metavar="W,P,D",
                   help="Savitzky-Golay window,polyorder,deriv "
                        "(e.g. 15,2,1)")
    p.add_argument("--remove-outliers", action="store_true",
                   help="per-class PCA-Mahalanobis outlier removal on the "
                        "training split")
    p.add_argument("--outlier-components", type=int, default=10)
    p.add_argument("--outlier-percentile", type=float, default=95.0)


def load_dataset(data: Optional[str], synthetic: str = "cheese",
                 seed: int = 42, test_size: float = 0.3):
    """Return ``(x_train, y_train, x_test, y_test)`` as numpy arrays."""
    if data:
        if data.endswith(".npz"):
            z = np.load(data)
            if "x_train" in z:
                missing = [k for k in ("y_train", "x_test", "y_test")
                           if k not in z]
                if missing:
                    raise ValueError(
                        f"{data}: has x_train but is missing {missing}; "
                        "provide all of x_train/y_train/x_test/y_test, or "
                        "use the x/y form for an unsplit chunk")
                return (np.asarray(z["x_train"]), np.asarray(z["y_train"]),
                        np.asarray(z["x_test"]), np.asarray(z["y_test"]))
            if "x" not in z or "y" not in z:
                raise ValueError(
                    f"{data}: expected keys x_train/y_train/x_test/y_test "
                    f"or x/y, found {sorted(z.files)}")
            x, y = np.asarray(z["x"]), np.asarray(z["y"])
            perm = np.random.default_rng(seed).permutation(len(y))
            x, y = x[perm], y[perm]
            n_tr = int(round((1.0 - test_size) * len(y)))
            return x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:]
        if data.endswith(".mat"):
            from ocm_tpu_torch.utils.io import load_cheese_mat

            return load_cheese_mat(data)
        if data.endswith((".h5", ".hdf5")):
            # the `ingest` store: per-class object pixel spectra, split at
            # the object level so no object straddles train and test
            from ocm_tpu_torch.utils.io import read_object_store
            from ocm_tpu_torch.utils.splits import shuffle_split

            store = read_object_store(data)
            xs_tr, ys_tr, xs_ts, ys_ts = [], [], [], []
            for i, cls in enumerate(sorted(store)):
                objs = [np.asarray(o["spectral_data"], np.float32)
                        for o in store[cls]]
                tr_objs, ts_objs = shuffle_split(objs, test_size,
                                                 random_state=seed)
                for dst_x, dst_y, part in ((xs_tr, ys_tr, tr_objs),
                                           (xs_ts, ys_ts, ts_objs)):
                    for o in part:
                        dst_x.append(o)
                        dst_y.append(np.full(len(o), i))
            return (np.concatenate(xs_tr), np.concatenate(ys_tr),
                    np.concatenate(xs_ts), np.concatenate(ys_ts))
        raise ValueError(f"unsupported data file {data!r} "
                         "(.npz, .mat, or .h5 object store)")

    from ocm_tpu_torch.utils import synthetic as S

    if synthetic == "cheese":
        return S.cheese_like(seed=seed)
    data_by_class = S.nut_objects(seed=seed)
    xs, ys = [], []
    for i, nut in enumerate(S.NUT_TYPES):
        block = np.concatenate(data_by_class[nut])
        xs.append(block)
        ys.append(np.full(len(block), i))
    x, y = np.concatenate(xs), np.concatenate(ys)
    perm = np.random.default_rng(seed).permutation(len(y))
    x, y = x[perm], y[perm]
    n_tr = int(round((1.0 - test_size) * len(y)))
    return x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:]


def _preprocess(args, *arrays):
    """The arrays through SNV / Savitzky-Golay on the run's device, back as
    numpy in the device's width (``_device.as_tensor``)."""
    from ocm_tpu_torch._device import as_tensor
    from ocm_tpu_torch.ops.preprocess import savgol_filter, snv

    out = []
    for x in arrays:
        x = as_tensor(x, args.device)
        if args.snv:
            x = snv(x)
        if args.savgol:
            w, p, d = (int(v) for v in args.savgol.split(","))
            x = savgol_filter(x, w, p, d)
        out.append(x.cpu().numpy())
    return out


def _remove_outliers(args, x, y):
    """Per-class PCA-score Mahalanobis outlier removal on the training
    split (keep rule: distance <= the percentile)."""
    if not getattr(args, "remove_outliers", False):
        return x, y
    from ocm_tpu_torch.utils.outliers import (effective_n_components,
                                              mahalanobis_outlier_mask)

    idx_parts = []
    for cls in np.unique(y):
        idx = np.where(y == cls)[0]
        k = effective_n_components(len(idx), x.shape[1],
                                   args.outlier_components)
        keep, _, _ = mahalanobis_outlier_mask(
            x[idx], n_components=k, percentile=args.outlier_percentile,
            device=args.device)
        idx_parts.append(idx[keep.cpu().numpy()])
    keep_idx = np.sort(np.concatenate(idx_parts))
    n_dropped = len(y) - len(keep_idx)
    if n_dropped:
        print(f"outlier removal: dropped {n_dropped}/{len(y)} "
              "training spectra")
    return x[keep_idx], y[keep_idx]


def _class_split(x, y, target_class: int, val_frac: float = 1 / 6):
    """Target-class calibration/validation split (the last sixth, at least
    4 spectra, validates)."""
    x_cls = x[y == target_class]
    n_val = max(int(len(x_cls) * val_frac), 4)
    if len(x_cls) <= n_val:
        raise ValueError(
            f"class {target_class} has {len(x_cls)} samples; needs more "
            f"than {n_val} for a calibration/validation split")
    return x_cls[:-n_val], x_cls[-n_val:]


def _binary_labels(y, target_class: int):
    """0 = target; the other classes get dense labels 1..K in sorted order,
    so that each false-acceptance column stays distinct and non-empty."""
    y = np.asarray(y)
    others = sorted(set(np.unique(y).tolist()) - {target_class})
    remap = {target_class: 0, **{c: i + 1 for i, c in enumerate(others)}}
    return np.array([remap[int(v)] for v in y], dtype=int)


# ------------------------------------------------------------- helpers


def _save_simca_model(out_dir: str, model, meta: dict) -> None:
    from ocm_tpu_torch.models.simca import save_simca_model
    from ocm_tpu_torch.utils.io import save_json

    save_simca_model(os.path.join(out_dir, SIMCA_MODEL_FILE), model)
    save_json(meta, out_dir, SIMCA_META_JSON)


def _load_simca_model(model_dir: str, device=None):
    from ocm_tpu_torch.models.simca import load_simca_model
    from ocm_tpu_torch.utils.io import load_json

    meta = load_json(model_dir, SIMCA_META_JSON)
    return (load_simca_model(os.path.join(model_dir, SIMCA_MODEL_FILE),
                             device), meta)


def _build_vae(arch: dict):
    from ocm_tpu_torch.models.vae import ConvVAE1D

    return ConvVAE1D(input_length=int(arch["input_length"]),
                     latent_dim=int(arch.get("latent_dim", 16)),
                     conv_blocks=int(arch.get("conv_blocks", 3)),
                     n_filters=int(arch.get("n_filters", 32)),
                     kernel_size=int(arch.get("kernel_size", 9)),
                     hidden_fc=int(arch.get("hidden_fc", 256)),
                     dropout=float(arch.get("dropout", 0.0)),
                     activation=arch.get("activation", "elu"))


def _load_vae_dir(model_dir: str, device=None):
    """(model, bundle, params) from a train-vae/hpo run dir; an
    --all-classes run dir's bundle comes back class-stacked."""
    from ocm_tpu_torch.models.bundle import load_bundle
    from ocm_tpu_torch.utils.io import load_json

    params_all = load_json(model_dir, "params.json")
    model = _build_vae(params_all["arch"])
    bundle = load_bundle(os.path.join(model_dir, BUNDLE_FILE), model, device)
    return model, bundle, params_all


def _variant_accept(model, bundle, vs, x, variant: str, loss_type: str):
    """Accept vector (numpy) of ONE class model under any of the five
    decision variants."""
    from ocm_tpu_torch.models import vae_decision as D
    from ocm_tpu_torch.models.vaesimca import predict_vaesimca

    if variant == "d2":
        acc = D.decide_d2(model, bundle, x).accept
    elif variant == "d2_q":
        acc = D.decide_d2_q(model, bundle, x, loss_type).accept
    elif variant == "f":
        acc = D.decide_f(model, bundle, x).accept
    elif variant == "full":
        acc = D.decide_full_distance(model, bundle, x).accept
    else:
        acc = predict_vaesimca(model, bundle, vs, x)[0]
    return acc.cpu().numpy()


def _vae_metrics(accept, y_ts, target_class: int) -> dict:
    from ocm_tpu_torch.stats.metrics import vae_binary_metrics

    y_bin = _binary_labels(y_ts, target_class)
    pred = np.where(np.asarray(accept), 0, 1)
    m = vae_binary_metrics(pred, y_bin, int(y_bin.max()) + 1, device="cpu")
    return {"accuracy": float(m.accuracy), "precision": float(m.precision),
            "recall": float(m.recall), "f1": float(m.f1),
            "mean_false_acceptance": float(m.mean_false_acceptance)}


def _conformity(y_ts, accept, cls) -> dict:
    from ocm_tpu_torch.stats.metrics import conformity_metrics

    m = conformity_metrics(np.asarray(y_ts), np.asarray(accept).astype(int),
                           cls, device="cpu")
    return {k: float(getattr(m, k)) for k in
            ("sensitivity", "specificity", "accuracy", "efficiency")}


# ------------------------------------------------------------ commands


def cmd_info(args) -> int:
    import ocm_tpu_torch
    from ocm_tpu_torch.ops import _build

    cuda = torch.cuda.is_available()
    print(f"ocm_tpu_torch {ocm_tpu_torch.__version__}")
    print(f"torch {torch.__version__} cuda={torch.version.cuda} "
          f"cudnn={torch.backends.cudnn.version()}")
    print(f"cuda available: {cuda}, devices: "
          f"{torch.cuda.device_count() if cuda else 0}")
    for i in range(torch.cuda.device_count() if cuda else 0):
        print(f"device {i}: {torch.cuda.get_device_name(i)}")
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(f"cudnn deterministic: {torch.backends.cudnn.deterministic}")
    print(f"kernel library built: {_build.library_path().exists()} "
          f"({_build.library_path().name})")
    return 0


def cmd_simca(args) -> int:
    from ocm_tpu_torch.models.simca import SIMCA, fit_classes
    from ocm_tpu_torch.utils.io import save_json

    x_tr, y_tr, x_ts, y_ts = load_dataset(args.data, args.synthetic,
                                          args.seed)
    x_tr, x_ts = _preprocess(args, x_tr, x_ts)
    x_tr, y_tr = _remove_outliers(args, x_tr, y_tr)
    os.makedirs(args.out_dir, exist_ok=True)

    # 'dd' needs the moment-matched limits (the SIMCA wrapper coerces this
    # itself; the raw fits do not)
    t2lim, qlim = args.t2lim, args.qlim
    if args.type == "dd":
        t2lim = qlim = "chi2pom"

    if args.all_classes:
        from ocm_tpu_torch.models.simca import predict_classes

        labels = sorted(int(c) for c in np.unique(y_tr))
        # the masked stacked fit calls its dense solver 'eigh' (fit_simca
        # calls the same decomposition 'svd')
        solver = "eigh" if args.solver == "svd" else args.solver
        stacked = fit_classes(x_tr, y_tr, labels,
                              n_components=args.n_components,
                              device=args.device, decision_type=args.type,
                              t2_method=t2lim, q_method=qlim, solver=solver)
        _save_simca_model(args.out_dir, stacked,
                          {"kind": "simca", "stacked": True,
                           "class_labels": labels,
                           "decision_type": args.type,
                           "n_components": args.n_components,
                           "t2lim": t2lim, "qlim": qlim})
        accept = predict_classes(stacked, x_ts,
                                 decision_type=args.type)[0].cpu().numpy()
        metrics = {str(cls): _conformity(y_ts, accept[i], cls)
                   for i, cls in enumerate(labels)}
    else:
        model = SIMCA(n_components=args.n_components,
                      model_class=args.target_class, type=args.type,
                      t2lim=t2lim, qlim=qlim, solver=args.solver,
                      verbose=not args.quiet, device=args.device)
        model.fit(x_tr, y_tr)
        model.predict(x_ts, y_true=y_ts)
        metrics = {str(args.target_class): model.metrics[args.target_class]}
        fitted = model._model[args.target_class]
        _save_simca_model(args.out_dir, fitted,
                          {"kind": "simca", "stacked": False,
                           "class_labels": [args.target_class],
                           "decision_type": args.type,
                           "n_components": args.n_components,
                           "t2lim": t2lim, "qlim": qlim})
        if args.plots:
            from ocm_tpu_torch.models.simca import reduced_train_distances
            from ocm_tpu_torch.utils.report import plot_t2q

            t2red, qred = reduced_train_distances(fitted, args.type)
            plot_t2q(t2red.cpu().numpy(), qred.cpu().numpy(),
                     d_limit=float(fitted.d_limit), decision_type=args.type,
                     title="train T2-Q",
                     save_path=os.path.join(args.out_dir, "t2q_train.png"))

    save_json(_params(args, "simca"), args.out_dir, "params.json")
    save_json(metrics, args.out_dir, "metrics.json")
    print(json.dumps(metrics, indent=2))
    return 0


def cmd_cv(args) -> int:
    from ocm_tpu_torch.models.cv import cv_simca_sweep
    from ocm_tpu_torch.utils.io import save_json

    x_tr, y_tr, x_ts, y_ts = load_dataset(args.data, args.synthetic,
                                          args.seed)
    x_tr, x_ts = _preprocess(args, x_tr, x_ts)
    x_tr, y_tr = _remove_outliers(args, x_tr, y_tr)
    lv_values = list(range(args.lv_min, args.lv_max + 1))
    res = cv_simca_sweep(x_tr, y_tr, args.target_class, lv_values,
                         n_splits=args.n_splits, decision_type=args.type,
                         t2_method=args.t2lim, q_method=args.qlim,
                         solver=args.solver, device=args.device)
    scores = np.asarray(res[args.metric])
    best_i = int(np.argmax(scores))
    best_lv = lv_values[best_i]
    os.makedirs(args.out_dir, exist_ok=True)
    save_json(_params(args, "cv"), args.out_dir, "params.json")
    save_json({"lv_values": lv_values,
               "spec": np.asarray(res["spec"]),
               "sens": np.asarray(res["sens"]),
               "eff": np.asarray(res["eff"]),
               "best_lv": best_lv, "metric": args.metric,
               "best_score": float(scores[best_i])},
              args.out_dir, "cv.json")
    if args.plots:
        from ocm_tpu_torch.utils.report import plot_cv

        plot_cv({"results": [{"LV": lv, "params": {},
                              args.metric: float(scores[i])}
                             for i, lv in enumerate(lv_values)],
                 "best_LV": best_lv, "best_score": float(scores[best_i])},
                metric=args.metric,
                save_path=os.path.join(args.out_dir, "cv.png"))
    if args.refit:
        from ocm_tpu_torch.models.simca import fit_simca

        # dd -> chi2pom, as the SIMCA wrapper (the sweep coerces itself;
        # the refit model must agree)
        t2lim, qlim = args.t2lim, args.qlim
        if args.type == "dd":
            t2lim = qlim = "chi2pom"
        fitted = fit_simca(x_tr[y_tr == args.target_class], best_lv,
                           decision_type=args.type, t2_method=t2lim,
                           q_method=qlim,
                           solver="svd" if args.solver == "eigh"
                           else args.solver, device=args.device)
        _save_simca_model(args.out_dir, fitted,
                          {"kind": "simca", "stacked": False,
                           "class_labels": [args.target_class],
                           "decision_type": args.type,
                           "n_components": best_lv,
                           "t2lim": t2lim, "qlim": qlim})
    print(f"best LV by {args.metric}: {best_lv} "
          f"(score {float(scores[best_i]):.4f})")
    return 0


def cmd_train_vae(args) -> int:
    from ocm_tpu_torch.models import vae_decision as D
    from ocm_tpu_torch.models.bundle import (class_slice, save_bundle,
                                             stack_bundles)
    from ocm_tpu_torch.models.stacked import seeded_vae
    from ocm_tpu_torch.models.trainer import TrainConfig, train_vae
    from ocm_tpu_torch.models.vaesimca import (fit_vaesimca,
                                               save_vaesimca_model)
    from ocm_tpu_torch.utils.io import save_json

    x_tr, y_tr, x_ts, y_ts = load_dataset(args.data, args.synthetic,
                                          args.seed)
    x_tr, x_ts = _preprocess(args, x_tr, x_ts)
    x_tr, y_tr = _remove_outliers(args, x_tr, y_tr)

    arch = {"input_length": int(x_tr.shape[1]),
            "latent_dim": args.latent_dim, "conv_blocks": args.conv_blocks,
            "n_filters": args.n_filters, "kernel_size": args.kernel_size,
            "hidden_fc": args.hidden_fc, "dropout": args.dropout,
            "activation": args.activation}
    model = _build_vae(arch)
    cfg = TrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                      lr=args.lr, weight_decay=args.weight_decay,
                      beta=args.beta, loss_type=args.loss_type)
    if args.all_classes:
        # every class's one-class VAE trains as ONE stacked module
        from ocm_tpu_torch.utils.sweep import train_vae_classes

        labels = sorted(int(c) for c in np.unique(y_tr))
        splits = [_class_split(x_tr, y_tr, cls) for cls in labels]
        result = train_vae_classes(model, [s[0] for s in splits],
                                   [s[1] for s in splits], cfg, args.seed,
                                   device=args.device)
        bundles, vss = [], []
        for i in range(len(labels)):
            b = D.fit_thresholds(model, class_slice(result.bundle, i),
                                 splits[i][0], loss_type=args.loss_type)
            bundles.append(b)
            vss.append(fit_vaesimca(model, b, splits[i][0]))
        bundle, vs = stack_bundles(bundles), stack_bundles(vss)
        best_epoch = np.asarray(result.best_epoch).tolist()
    else:
        labels = None
        x_cal, x_val = _class_split(x_tr, y_tr, args.target_class)
        model = seeded_vae(model, args.seed)
        result = train_vae(model, x_cal, x_val, cfg, args.seed,
                           device=args.device)
        bundle = D.fit_thresholds(model, result.bundle, x_cal,
                                  loss_type=args.loss_type)
        vs = fit_vaesimca(model, bundle, x_cal)
        best_epoch = int(result.best_epoch)

    os.makedirs(args.out_dir, exist_ok=True)
    save_json({"command": "train-vae", "arch": arch,
               "train": {"epochs": args.epochs,
                         "batch_size": args.batch_size, "lr": args.lr,
                         "weight_decay": args.weight_decay,
                         "beta": args.beta, "loss_type": args.loss_type},
               "target_class": args.target_class,
               "class_labels": labels, "seed": args.seed},
              args.out_dir, "params.json")
    save_json({"train_losses": np.asarray(result.train_losses),
               "val_losses": np.asarray(result.val_losses),
               "best_epoch": best_epoch},
              args.out_dir, "losses.json")
    save_bundle(os.path.join(args.out_dir, BUNDLE_FILE), bundle, model)
    save_vaesimca_model(os.path.join(args.out_dir, VAESIMCA_FILE), vs)
    if args.plots:
        from ocm_tpu_torch.utils.report import plot_losses

        tl = np.atleast_2d(np.asarray(result.train_losses))
        vl = np.atleast_2d(np.asarray(result.val_losses))
        for i in range(tl.shape[0]):
            cls = labels[i] if labels is not None else args.target_class
            plot_losses(tl[i], vl[i],
                        best_epoch=(best_epoch[i] if labels is not None
                                    else best_epoch),
                        title=f"class {cls} {args.loss_type} loss",
                        save_path=os.path.join(args.out_dir,
                                               f"losses_c{cls}.png"))

    metrics = {}
    for variant in VARIANTS:
        if labels is not None:
            metrics[variant] = {
                str(cls): _vae_metrics(_variant_accept(
                    model, class_slice(bundle, i), class_slice(vs, i), x_ts,
                    variant, args.loss_type), y_ts, cls)
                for i, cls in enumerate(labels)}
        else:
            metrics[variant] = _vae_metrics(
                _variant_accept(model, bundle, vs, x_ts, variant,
                                args.loss_type), y_ts, args.target_class)
    save_json(metrics, args.out_dir, "metrics.json")
    print(json.dumps(metrics, indent=2))
    return 0


def _build_scorer(model_dir: str, chunk_size: int = 8192,
                  store_dtype: Optional[str] = None, variant: str = "d2",
                  pin_f_stats: bool = False, device=None):
    """(scorer, info) from any model-producing run dir (simca /
    cv --refit / stream-fit / train-vae / hpo), on ``device`` (CUDA unless
    given).  Shared by ``screen`` and ``serve``."""
    sd = {None: None, "bf16": torch.bfloat16, "int8": torch.int8}[store_dtype]
    if os.path.exists(os.path.join(model_dir, SIMCA_MODEL_FILE)):
        from ocm_tpu_torch.serving import SIMCAScorer

        model, meta = _load_simca_model(model_dir, device)
        scorer = SIMCAScorer(model, decision_type=meta["decision_type"],
                             chunk_size=chunk_size, store_dtype=sd)
        info = dict(meta, input_length=int(model.mean.shape[-1]),
                    store_dtype=store_dtype, chunk_size=chunk_size)
        return scorer, info

    from ocm_tpu_torch.serving import VAEScorer

    if not os.path.exists(os.path.join(model_dir, "params.json")):
        raise SystemExit(
            f"{model_dir} is not a model run dir (no {SIMCA_MODEL_FILE} "
            "and no params.json) — point --model-dir at a simca / "
            "cv --refit / stream-fit / train-vae / hpo output dir")
    if store_dtype == "int8":
        raise SystemExit("--store-dtype int8 is a SIMCA quantized-"
                         "residual store; VAE serving supports bf16")
    if pin_f_stats and variant != "f":
        raise SystemExit("--pin-f-stats applies only to --variant f "
                         "(the quirk-Q3 batch statistics)")
    model, bundle, params_all = _load_vae_dir(model_dir, device)
    if sd is torch.bfloat16 and bundle.spec_mean.dtype != torch.float32:
        # the bf16 twin reduces a float32 bundle (a CPU run dir is float64)
        bundle = bundle._replace(
            state_dict={k: v.float() if v.is_floating_point() else v
                        for k, v in bundle.state_dict.items()},
            **{f: getattr(bundle, f).float()
               for f in bundle._fields if f != "state_dict"})
    loss_type = params_all.get("train", {}).get("loss_type", "cosine")
    vaesimca_model = None
    if variant == "vaesimca":
        from ocm_tpu_torch.models.vaesimca import load_vaesimca_model

        vs_path = os.path.join(model_dir, VAESIMCA_FILE)
        if not os.path.exists(vs_path):
            raise SystemExit(
                f"{model_dir} has no {VAESIMCA_FILE}; re-run train-vae "
                "(it saves the latent-SIMCA state alongside the bundle)")
        vaesimca_model = load_vaesimca_model(vs_path, device)
    scorer = VAEScorer(model, bundle, variant=variant, loss_type=loss_type,
                       chunk_size=chunk_size, vaesimca_model=vaesimca_model,
                       compute_dtype=sd, pin_f_stats=pin_f_stats)
    info = {"kind": "vae", "variant": variant, "loss_type": loss_type,
            "pin_f_stats": bool(pin_f_stats),
            "target_class": int(params_all.get("target_class", 0)),
            "class_labels": params_all.get("class_labels"),
            "input_length": int(params_all["arch"]["input_length"]),
            "store_dtype": store_dtype, "chunk_size": chunk_size}
    return scorer, info


def cmd_screen(args) -> int:
    from ocm_tpu_torch.utils.io import save_json

    x_tr, y_tr, x_ts, y_ts = load_dataset(args.data, args.synthetic,
                                          args.seed)
    if args.use_train:
        x_ts, y_ts = x_tr, y_tr
    (x_ts,) = _preprocess(args, x_ts)

    scorer, info = _build_scorer(args.model_dir, args.chunk_size,
                                 args.store_dtype, args.variant,
                                 pin_f_stats=args.pin_f_stats,
                                 device=args.device)
    out = scorer.score(x_ts)
    metrics = None
    if not args.no_metrics:
        accept = np.asarray(out["accept"])
        if info.get("kind") == "simca":
            per_cls = accept.T if accept.ndim == 2 else accept[None, :]
            metrics = {str(cls): _conformity(y_ts, per_cls[i], cls)
                       for i, cls in enumerate(info["class_labels"])}
        elif accept.ndim == 2:      # stacked multi-class VAE run dir
            metrics = {args.variant: {
                str(cls): _vae_metrics(accept[:, i], y_ts, cls)
                for i, cls in enumerate(info["class_labels"])}}
        else:
            metrics = {args.variant: _vae_metrics(
                accept, y_ts, info["target_class"])}

    os.makedirs(args.out_dir, exist_ok=True)
    np.savez(os.path.join(args.out_dir, "predictions.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    save_json(_params(args, "screen"), args.out_dir, "params.json")
    if metrics is not None:
        save_json(metrics, args.out_dir, "metrics.json")
        print(json.dumps(metrics, indent=2))
    n = len(np.asarray(out["accept"]))
    print(f"screened {n} spectra -> "
          f"{os.path.join(args.out_dir, 'predictions.npz')}")
    return 0


def cmd_hpo(args) -> int:
    from ocm_tpu_torch.models.bundle import save_bundle
    from ocm_tpu_torch.utils.io import save_json

    x_tr, y_tr, _, _ = load_dataset(args.data, args.synthetic, args.seed)
    (x_tr,) = _preprocess(args, x_tr)
    x_tr, y_tr = _remove_outliers(args, x_tr, y_tr)
    x_cal, x_val = _class_split(x_tr, y_tr, args.target_class)

    space = None
    if args.space:
        with open(args.space) as f:
            raw = json.load(f)
        # {"lr": ["loguniform", 1e-4, 1e-2],
        #  "batch_size": ["categorical", [32, 64]]}
        space = {k: tuple(v) for k, v in raw.items()}

    kw = dict(space=space, max_epochs=args.max_epochs, seed=args.seed,
              base_config={"loss_type": args.loss_type},
              verbose=not args.quiet, device=args.device)
    if args.algo == "tpe":
        from ocm_tpu_torch.utils.tpe import tpe_vae_search

        res = tpe_vae_search(x_cal, x_val, n_trials=args.n_trials, **kw)
    elif args.algo == "asha":
        from ocm_tpu_torch.utils.sweep import asha_vae_search

        res = asha_vae_search(x_cal, x_val, n_trials=args.n_trials, **kw)
    else:
        from ocm_tpu_torch.utils.tpe import bohb_vae_search

        # --n-trials maps onto 3 TPE-sampled brackets
        res = bohb_vae_search(x_cal, x_val, trials_per_bracket=max(
            1, -(-args.n_trials // 3)), **kw)

    os.makedirs(args.out_dir, exist_ok=True)
    best_cfg = dict(res["best_config"])
    arch = {"input_length": int(x_tr.shape[1]),
            "latent_dim": int(best_cfg.get("latent_dim", 16)),
            "conv_blocks": int(best_cfg.get("conv_blocks", 3)),
            "n_filters": int(best_cfg.get("n_filters", 32)),
            "kernel_size": int(best_cfg.get("kernel_size", 9)),
            "hidden_fc": int(best_cfg.get("hidden_fc", 256)),
            "dropout": float(best_cfg.get("dropout", 0.0)),
            "activation": best_cfg.get("activation", "elu")}
    save_json({"command": "hpo", "algo": args.algo, "arch": arch,
               "train": {"loss_type": args.loss_type},
               "target_class": args.target_class,
               "best_config": best_cfg,
               "best_value": float(res["best_value"]),
               "total_epochs": int(res["total_epochs"])},
              args.out_dir, "params.json")
    save_json({"history": res["history"]}, args.out_dir, "trials.json")
    if res.get("best_bundle") is not None:
        from ocm_tpu_torch.models import vae_decision as D

        model = _build_vae(arch)
        bundle = D.fit_thresholds(model, res["best_bundle"], x_cal,
                                  loss_type=args.loss_type)
        save_bundle(os.path.join(args.out_dir, BUNDLE_FILE), bundle, model)
    print(f"best {args.algo} config: {best_cfg} "
          f"(val loss {float(res['best_value']):.5f}, "
          f"{int(res['total_epochs'])} total epochs)")
    return 0


def _moments_meta_path(moments_path: str) -> str:
    return moments_path + ".meta.json"


def cmd_stream_update(args) -> int:
    """Ingest one dataset chunk into a persisted streaming statistic
    (``models.streaming``)."""
    from ocm_tpu_torch.models import streaming as ST

    x_tr, y_tr, x_ts, y_ts = load_dataset(args.data, args.synthetic,
                                          args.seed)
    if args.split == "train":
        x, y = x_tr, y_tr
    elif args.split == "test":
        x, y = x_ts, y_ts
    else:
        x = np.concatenate([x_tr, x_ts])
        y = np.concatenate([y_tr, y_ts])
    (x,) = _preprocess(args, x)
    x, y = _remove_outliers(args, x, y)

    class_labels = None
    if args.class_labels:
        class_labels = [int(c) for c in args.class_labels.split(",")]

    length = x.shape[1]
    if os.path.exists(args.moments):
        mom = ST.load_moments(args.moments, length=length,
                              device=args.device)
        if os.path.exists(_moments_meta_path(args.moments)):
            with open(_moments_meta_path(args.moments)) as f:
                stored = json.load(f)["class_labels"]
            if class_labels is not None and class_labels != stored:
                raise SystemExit(
                    f"--class-labels {class_labels} does not match the "
                    f"existing statistic's {stored}")
            class_labels = stored
        elif class_labels is not None:
            raise SystemExit(
                f"{args.moments} is a single-class statistic; it cannot "
                "take --class-labels")
    elif class_labels is not None:
        mom = ST.moments_init_classes(len(class_labels), length,
                                      device=args.device)
    else:
        mom = ST.moments_init(length, device=args.device)

    if class_labels is not None:
        mom = ST.moments_update_classes(mom, x, y, class_labels)
        counts = [int(c) for c in mom.n.tolist()]
        total = sum(counts)
    else:
        if args.target_class is not None:
            x = x[y == args.target_class]
        mom = ST.moments_update(mom, x)
        counts, total = None, int(mom.n)

    os.makedirs(os.path.dirname(os.path.abspath(args.moments)),
                exist_ok=True)
    ST.save_moments(args.moments, mom)
    if class_labels is not None:
        with open(_moments_meta_path(args.moments), "w") as f:
            json.dump({"class_labels": class_labels}, f)
        print(f"ingested {len(x)} rows -> {args.moments}: "
              f"per-class counts {dict(zip(class_labels, counts))}")
    else:
        print(f"ingested {len(x)} rows -> {args.moments}: total n={total}")
    return 0


def cmd_stream_fit(args) -> int:
    """Fit a servable SIMCA model dir from a streaming statistic alone."""
    from ocm_tpu_torch.models import streaming as ST
    from ocm_tpu_torch.utils.io import save_json

    mom = ST.load_moments(args.moments, device=args.device)
    stacked = mom.mean.dim() == 2
    kwargs = dict(decision_type=args.type, t2_method=args.t2lim,
                  q_method=args.qlim, solver=args.solver)
    if stacked:
        if os.path.exists(_moments_meta_path(args.moments)):
            with open(_moments_meta_path(args.moments)) as f:
                class_labels = json.load(f)["class_labels"]
        else:
            class_labels = list(range(mom.mean.shape[0]))
        model = ST.fit_classes_moments(mom, args.n_components, **kwargs)
    else:
        class_labels = [args.target_class]
        model = ST.fit_simca_moments(mom, args.n_components, **kwargs)

    os.makedirs(args.out_dir, exist_ok=True)
    _save_simca_model(args.out_dir, model,
                      {"kind": "simca", "stacked": stacked,
                       "class_labels": class_labels,
                       "decision_type": args.type,
                       "n_components": args.n_components,
                       "t2lim": args.t2lim, "qlim": args.qlim,
                       "streaming": True})
    save_json(_params(args, "stream-fit"), args.out_dir, "params.json")
    n = mom.n.tolist()
    print(f"fitted {'stacked ' if stacked else ''}model from "
          f"n={[int(v) for v in n] if stacked else int(n)} streamed "
          f"spectra -> {args.out_dir}")
    return 0


def cmd_plsda(args) -> int:
    """Multi-class PLS-DA baseline: CV F1 curve -> best-k refit -> test
    confusion."""
    from ocm_tpu_torch.models.plsda import plsda_f1_curves, plsda_fit_predict
    from ocm_tpu_torch.utils.io import save_json

    x_tr, y_tr, x_ts, y_ts = load_dataset(args.data, args.synthetic,
                                          args.seed)
    x_tr, x_ts = _preprocess(args, x_tr, x_ts)
    max_k = min(args.max_components, x_tr.shape[1],
                len(x_tr) - len(x_tr) // args.n_folds - 1)
    curves = plsda_f1_curves(x_tr, y_tr, max_components=max_k,
                             n_folds=args.n_folds, random_state=args.seed,
                             device=args.device)
    best_k = curves["best_n_components"]
    res = plsda_fit_predict(x_tr, y_tr, x_ts, y_ts, best_k,
                            device=args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    save_json(_params(args, "plsda"), args.out_dir, "params.json")
    save_json({"f1_cal": curves["f1_cal"], "f1_cv": curves["f1_cv"],
               "best_n_components": best_k}, args.out_dir, "cv.json")
    save_json({"best_n_components": best_k, "f1_test": res.f1_test,
               "confusion": np.asarray(res.confusion).tolist()},
              args.out_dir, "metrics.json")
    if args.plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ks = np.arange(1, max_k + 1)
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(ks, np.asarray(curves["f1_cal"]), label="calibration")
        ax.plot(ks, np.asarray(curves["f1_cv"]),
                label=f"{args.n_folds}-fold CV")
        ax.axvline(best_k, ls="--", c="gray", label=f"best k={best_k}")
        ax.set_xlabel("PLS components")
        ax.set_ylabel("macro F1")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(args.out_dir, "plsda_f1.png"), dpi=120)
        plt.close(fig)
    print(f"best k={best_k}, test macro-F1={float(res.f1_test):.4f}")
    return 0


def cmd_ingest(args) -> int:
    from ocm_tpu_torch.utils.io import extract_objects, write_object_store

    # class -> list of images, each a list of object dicts
    data = {}
    if args.cube:
        for spec in args.cube:
            if "=" not in spec:
                raise SystemExit(f"--cube expects class=path, got {spec!r}")
            cls, path = spec.split("=", 1)
            cube = np.load(path)
            data.setdefault(cls, []).append(
                extract_objects(cube, args.background_threshold,
                                min_pixels=args.min_pixels))
    else:
        from ocm_tpu_torch.utils import synthetic as S

        for i, nut in enumerate(S.NUT_TYPES):
            data[nut] = [
                extract_objects(S.nut_cube(seed=100 * i + img, nut_idx=i),
                                args.background_threshold,
                                min_pixels=args.min_pixels)
                for img in range(args.images_per_class)]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_object_store(args.out, data)
    n_obj = sum(len(objs) for v in data.values() for objs in v)
    n_px = sum(o["n_pixels"] for v in data.values() for objs in v
               for o in objs)
    print(f"wrote {args.out}: {len(data)} classes, {n_obj} objects, "
          f"{n_px} pixel spectra")
    return 0


def make_server(args):
    """The ``serve`` command's ``ScoringServer`` (bound, not started), with
    a ``reload_fn`` that rebuilds from a given run dir or the original."""
    from ocm_tpu_torch.server import ScoringServer

    def build(model_dir):
        return _build_scorer(model_dir, args.chunk_size, args.store_dtype,
                             args.variant, pin_f_stats=args.pin_f_stats,
                             device=args.device)

    def reload_fn(model_dir):
        # POST /reload [{"model_dir": ...}]: another run dir, or the
        # original one re-read (a stream-fit refresh rewrites it in place)
        sc, inf = build(model_dir or args.model_dir)
        return sc, inf, inf.get("input_length")

    scorer, info = build(args.model_dir)
    return ScoringServer(scorer, info, host=args.host, port=args.port,
                         expected_length=info.get("input_length"),
                         max_queue=args.max_queue, reload_fn=reload_fn)


def cmd_serve(args) -> int:
    """Resident HTTP scoring server over a saved model dir."""
    srv = make_server(args)
    if not args.no_warmup:
        print("warming up (kernel library build and first launch)...")
        srv.warmup()
    print(f"serving {srv.info.get('kind', 'model')} model at "
          f"http://{srv.host}:{srv.port}  (POST /score, GET /health)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.stop()
    return 0


def cmd_export_torch(args) -> int:
    from ocm_tpu_torch.models.bundle import class_slice
    from ocm_tpu_torch.models.torch_export import save_torch_checkpoint

    model, bundle, params_all = _load_vae_dir(args.model_dir, args.device)
    labels = params_all.get("class_labels")
    if labels:
        # the reference format is one class per .pth; slice the stack
        if args.class_index is None:
            raise SystemExit(
                f"{args.model_dir} is an --all-classes run over classes "
                f"{labels}; pass --class-index to pick one")
        if args.class_index not in labels:
            raise SystemExit(f"--class-index {args.class_index} not in "
                             f"{labels}")
        bundle = class_slice(bundle, labels.index(args.class_index))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    path = save_torch_checkpoint(args.out, bundle, model)
    print(f"wrote reference-format checkpoint: {path}")
    return 0


def _params(args, command: str) -> dict:
    """The run's flags for ``params.json`` (the resolved device as text)."""
    return {k: (str(v) if isinstance(v, torch.device) else v)
            for k, v in vars(args).items()} | {"command": command}


# --------------------------------------------------------------- parser


class _Parser(argparse.ArgumentParser):
    """Subcommand parser with prefix abbreviation OFF (an abbreviated
    ``--out`` must error against ``--out-dir``/``--outlier-components``,
    not silently pick one) and ``--platform`` accepted AFTER the
    subcommand too.  SUPPRESS keeps a sub-level default from clobbering a
    top-level ``--platform cpu`` (argparse reuses one namespace)."""

    def __init__(self, *a, **kw):
        kw.setdefault("allow_abbrev", False)
        super().__init__(*a, **kw)
        self.add_argument("--platform", choices=["cpu", "cuda"],
                          default=argparse.SUPPRESS,
                          help="device to run on (default: cuda)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ocm_tpu_torch",
        description="one-class chemometrics on the GPU: the CLI",
        allow_abbrev=False)
    p.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                   help="device to run on (default: cuda)")
    sub = p.add_subparsers(dest="command", required=True,
                           parser_class=_Parser)

    sub.add_parser("info", help="torch / CUDA / card report")

    ps = sub.add_parser("simca", help="classical SIMCA fit + evaluate")
    _add_data_args(ps)
    ps.add_argument("--target-class", type=int, default=0)
    ps.add_argument("--all-classes", action="store_true",
                    help="fit every class as one batched solve")
    ps.add_argument("--n-components", type=int, default=10)
    ps.add_argument("--type", default="alt",
                    choices=["sim", "alt", "ci", "dd"])
    ps.add_argument("--t2lim", default="Fdist")
    ps.add_argument("--qlim", default="jm")
    ps.add_argument("--solver", default="svd",
                    choices=["svd", "eigh", "rsvd"])
    ps.add_argument("--plots", action="store_true")
    ps.add_argument("--quiet", action="store_true")
    ps.add_argument("--out-dir", default="out/cli_simca")

    pc = sub.add_parser("cv", help="fold x LV cross-validation sweep")
    _add_data_args(pc)
    pc.add_argument("--target-class", type=int, default=0)
    pc.add_argument("--lv-min", type=int, default=2)
    pc.add_argument("--lv-max", type=int, default=10)
    pc.add_argument("--n-splits", type=int, default=5)
    pc.add_argument("--type", default="alt",
                    choices=["sim", "alt", "ci", "dd"])
    pc.add_argument("--t2lim", default="Fdist")
    pc.add_argument("--qlim", default="jm")
    pc.add_argument("--solver", default="eigh", choices=["eigh", "rsvd"])
    pc.add_argument("--metric", default="eff",
                    choices=["eff", "spec", "sens"])
    pc.add_argument("--refit", action="store_true",
                    help="refit at the best LV and save the model")
    pc.add_argument("--plots", action="store_true")
    pc.add_argument("--out-dir", default="out/cli_cv")

    pt = sub.add_parser("train-vae", help="train ConvVAE1D + thresholds")
    _add_data_args(pt)
    pt.add_argument("--target-class", type=int, default=0)
    pt.add_argument("--all-classes", action="store_true",
                    help="train every class's one-class VAE as ONE "
                         "stacked module (utils.sweep.train_vae_classes)")
    pt.add_argument("--epochs", type=int, default=100)
    pt.add_argument("--batch-size", type=int, default=64)
    pt.add_argument("--lr", type=float, default=1e-3)
    pt.add_argument("--weight-decay", type=float, default=0.0)
    pt.add_argument("--beta", type=float, default=1.0)
    pt.add_argument("--loss-type", default="cosine",
                    choices=["cosine", "bce", "euclidean", "bce_prob"])
    pt.add_argument("--latent-dim", type=int, default=16)
    pt.add_argument("--conv-blocks", type=int, default=3)
    pt.add_argument("--n-filters", type=int, default=32)
    pt.add_argument("--kernel-size", type=int, default=9)
    pt.add_argument("--hidden-fc", type=int, default=256)
    pt.add_argument("--dropout", type=float, default=0.0)
    pt.add_argument("--activation", default="elu")
    pt.add_argument("--plots", action="store_true",
                    help="save per-class train/val loss curves")
    pt.add_argument("--out-dir", default="out/cli_vae")

    pr = sub.add_parser("screen", help="score a saved model over a dataset")
    _add_data_args(pr)
    pr.add_argument("--model-dir", required=True,
                    help="a simca/cv --refit/train-vae/hpo output dir")
    pr.add_argument("--variant", default="d2", choices=list(VARIANTS),
                    help="VAE decision variant (ignored for SIMCA models)")
    pr.add_argument("--store-dtype", default=None,
                    choices=["bf16", "int8"],
                    help="quantized serving (SIMCA store / VAE compute)")
    pr.add_argument("--chunk-size", type=int, default=8192)
    pr.add_argument("--pin-f-stats", action="store_true",
                    help="variant-f only: compute the quirk-Q3 batch "
                         "statistics on the host in float64 "
                         "(docs/PARITY.md Q3)")
    pr.add_argument("--use-train", action="store_true",
                    help="screen the training split instead of test")
    pr.add_argument("--no-metrics", action="store_true")
    pr.add_argument("--out-dir", default="out/cli_screen")

    ph = sub.add_parser("hpo", help="hyperparameter search")
    _add_data_args(ph)
    ph.add_argument("--target-class", type=int, default=0)
    ph.add_argument("--algo", default="tpe",
                    choices=["tpe", "asha", "bohb"])
    ph.add_argument("--n-trials", type=int, default=16)
    ph.add_argument("--max-epochs", type=int, default=27)
    ph.add_argument("--loss-type", default="cosine")
    ph.add_argument("--space", default=None,
                    help="JSON file: name -> [kind, lo, hi] or "
                         "[categorical, [choices]]")
    ph.add_argument("--quiet", action="store_true")
    ph.add_argument("--out-dir", default="out/cli_hpo")

    pv = sub.add_parser("serve", help="HTTP scoring server over a "
                                      "saved model dir")
    pv.add_argument("--model-dir", required=True)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8420)
    pv.add_argument("--variant", default="d2", choices=list(VARIANTS))
    pv.add_argument("--store-dtype", default=None,
                    choices=["bf16", "int8"])
    pv.add_argument("--chunk-size", type=int, default=8192)
    pv.add_argument("--pin-f-stats", action="store_true",
                    help="variant-f only: host-f64 quirk-Q3 statistics "
                         "(docs/PARITY.md Q3)")
    pv.add_argument("--max-queue", type=int, default=8,
                    help="max requests held for the device at once; "
                         "excess get 429")
    pv.add_argument("--no-warmup", action="store_true")

    pu = sub.add_parser("stream-update",
                        help="ingest a dataset chunk into a streaming "
                             "statistic")
    _add_data_args(pu)
    pu.add_argument("--moments", required=True,
                    help="statistic file (msgpack); created if absent")
    pu.add_argument("--split", default="train",
                    choices=["train", "test", "all"],
                    help="which slice of the dataset to ingest")
    pu.add_argument("--target-class", type=int, default=None,
                    help="ingest only rows with this label "
                         "(single-class stream)")
    pu.add_argument("--class-labels", default=None, metavar="0,1,2",
                    help="comma-separated labels for a stacked per-class "
                         "stream (one batched ingest per chunk)")

    pf = sub.add_parser("stream-fit",
                        help="fit a servable SIMCA model from a "
                             "streaming statistic")
    pf.add_argument("--moments", required=True)
    pf.add_argument("--target-class", type=int, default=0,
                    help="label recorded for a single-class statistic")
    pf.add_argument("--n-components", type=int, default=10)
    pf.add_argument("--type", default="alt", choices=["sim", "alt", "ci"])
    pf.add_argument("--t2lim", default="Fdist",
                    choices=["Fdist", "Fdistrig", "chi2"])
    pf.add_argument("--qlim", default="jm", choices=["jm", "chi2box"])
    pf.add_argument("--solver", default="eigh", choices=["eigh", "rsvd"])
    pf.add_argument("--out-dir", default="out/cli_stream")

    pp = sub.add_parser("plsda", help="multi-class PLS-DA baseline")
    _add_data_args(pp)
    pp.add_argument("--max-components", type=int, default=25)
    pp.add_argument("--n-folds", type=int, default=5)
    pp.add_argument("--plots", action="store_true")
    pp.add_argument("--out-dir", default="out/cli_plsda")

    pi = sub.add_parser("ingest", help="HSI cubes -> HDF5 object store")
    pi.add_argument("--cube", action="append", default=None,
                    metavar="CLASS=cube.npy",
                    help="repeatable; omit for synthetic cubes")
    pi.add_argument("--images-per-class", type=int, default=2)
    pi.add_argument("--background-threshold", type=float, default=0.35)
    pi.add_argument("--min-pixels", type=int, default=8)
    pi.add_argument("--out", default="out/object_store.h5")

    pe = sub.add_parser("export-torch",
                        help="bundle -> reference-format .pth")
    pe.add_argument("--model-dir", required=True)
    pe.add_argument("--out", default="out/model.pth")
    pe.add_argument("--class-index", type=int, default=None,
                    help="which class to export from an --all-classes "
                         "run dir (label value)")

    return p


COMMANDS = {"info": cmd_info, "simca": cmd_simca, "cv": cmd_cv,
            "train-vae": cmd_train_vae, "screen": cmd_screen,
            "hpo": cmd_hpo, "ingest": cmd_ingest,
            "export-torch": cmd_export_torch,
            "stream-update": cmd_stream_update,
            "stream-fit": cmd_stream_fit, "plsda": cmd_plsda,
            "serve": cmd_serve}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # full f32 on the card: TF32 products collapse the jm Q limits and
    # move the VAE off the reference (ROADMAP.md's port ground rules)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the run's device: cuda unless --platform cpu; the entry points raise
    # where there is no card (nothing falls back to the CPU)
    args.device = torch.device(args.platform or "cuda")
    return COMMANDS[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
