"""Hyperparameter sweeps: the grid runner, config- and class-stacked VAE
training, successive halving, and the Optuna hook.

Port of ``ocm_tpu/utils/sweep.py``.  The reference sweeps with sequential
host loops over ``itertools.product`` grids and an Optuna TPE study
(``optim_bce_nuts.py``); each run writes ``params.json`` /
``losses.json`` / ``metrics.json`` into its own directory plus global
``all_params.json`` / ``all_metrics.json``.

- ``run_vae_sweep`` persists each run and resumes: a run whose
  ``metrics.json`` exists is read back and trains nothing.
- ``train_vae_vmapped`` trains C configs of one architecture as one
  ``models.stacked.StackedVAE`` on the card (JAX vmaps them): config c
  runs what ``train_vae(seeded_vae(model, s_c), ..., seed=s_c)`` runs,
  with its own lr, weight decay, beta and random streams, and one launch
  of each training kernel (K2/K3 a BatchNorm layer, K4, K6's backward) a
  step serves every config.  ``train_vae_classes`` stacks classes the same
  way: per-class data, standardization and seeds.
- ``asha_vae_search``: successive halving; each architecture group's rung
  is one ``train_vae_vmapped`` call, and survivors resume from their exact
  weights, Adam state and streams.
- Seeds: ``models.stacked.config_seed(seed, i)`` is config (or trial, or
  class) i's seed, where ``ocm_tpu`` splits or folds a JAX key.
- Optuna is optional: ``optuna_objective`` and ``run_optuna_study`` adapt
  a config-dict objective, ``random_search`` is the dependency-free
  fallback.  Host bookkeeping (grids, sampling) is the JAX package's own
  numpy, copied, so one seed gives the same configs in both packages.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from ocm_tpu_torch._device import resolve_device
from ocm_tpu_torch.models.bundle import (new_bundle, spectral_stats,
                                         stack_bundles)
from ocm_tpu_torch.models.stacked import (StackedAdam, config_seed,
                                          make_stacked_eval_loss,
                                          make_stacked_train_step,
                                          seeded_vae, stacked_vae,
                                          unstack_state)
from ocm_tpu_torch.models.trainer import (TrainConfig, TrainResult,
                                          _clone_state, _dtype_of,
                                          batch_indices, epoch_generator)
from ocm_tpu_torch.models.vae import ConvVAE1D
from ocm_tpu_torch.parallel.mesh import cyclic_pad_to
from ocm_tpu_torch.utils.io import load_json, save_json


def grid_product(base: Mapping, grid: Mapping[str, Sequence]) -> list[dict]:
    """base params + cartesian grid (utils/final_vaesimca.py:296 pattern)."""
    keys = list(grid)
    out = []
    for values in itertools.product(*(grid[k] for k in keys)):
        out.append({**base, **dict(zip(keys, values))})
    return out


def vae_from_config(input_length: int, cfg: Mapping) -> ConvVAE1D:
    """The ``ConvVAE1D`` a sweep config names (the architecture keys, with
    the JAX package's defaults)."""
    return ConvVAE1D(
        input_length=int(input_length),
        latent_dim=int(cfg.get("latent_dim", 16)),
        conv_blocks=int(cfg.get("conv_blocks", 3)),
        n_filters=int(cfg.get("n_filters", 32)),
        kernel_size=int(cfg.get("kernel_size", 9)),
        hidden_fc=int(cfg.get("hidden_fc", 256)),
        dropout=float(cfg.get("dropout", 0.0)),
        activation=cfg.get("activation", "elu"))


def run_vae_sweep(configs: Sequence[Mapping], x_cal, x_val, x_test, y_test,
                  out_dir: str, evaluate: Optional[Callable] = None,
                  seed: int = 42, verbose: bool = True,
                  device=None) -> list[dict]:
    """Sequential sweep with per-run artifacts and resume.

    Each config dict holds architecture keys (latent_dim, conv_blocks,
    n_filters, kernel_size, hidden_fc, dropout, activation) and training
    keys (epochs, batch_size, lr, weight_decay, beta, loss_type).  Run i
    trains ``seeded_vae`` of its architecture with seed
    ``config_seed(seed, i)`` (``ocm_tpu`` folds i into its key), fits the
    thresholds, evaluates (``evaluate(model, bundle, x_test, y_test)``, or
    the D^2 decision's binary metrics) and writes its artifacts, the
    deployable ``model_bundle.msgpack`` among them.  A run with an existing
    ``metrics.json`` is read back instead (resume).
    """
    from ocm_tpu_torch.models.bundle import save_bundle
    from ocm_tpu_torch.models.trainer import train_vae
    from ocm_tpu_torch.models.vae_decision import decide_d2, fit_thresholds
    from ocm_tpu_torch.stats.metrics import vae_binary_metrics

    results = []
    for i, cfg_dict in enumerate(configs):
        run_dir = os.path.join(out_dir, f"run_{i:04d}")
        if os.path.exists(os.path.join(run_dir, "metrics.json")):
            if verbose:
                print(f"[sweep] run_{i:04d}: resume — already complete")
            results.append(load_json(run_dir, "metrics.json"))
            continue

        run_seed = config_seed(seed, i)
        model = seeded_vae(vae_from_config(np.shape(x_cal)[1], cfg_dict),
                           run_seed)
        tcfg = TrainConfig(
            epochs=int(cfg_dict.get("epochs", 100)),
            batch_size=int(cfg_dict.get("batch_size", 64)),
            lr=float(cfg_dict.get("lr", 1e-3)),
            weight_decay=float(cfg_dict.get("weight_decay", 0.0)),
            beta=float(cfg_dict.get("beta", 1.0)),
            loss_type=cfg_dict.get("loss_type", "cosine"))
        result = train_vae(model, x_cal, x_val, tcfg, run_seed,
                           device=device)
        bundle = fit_thresholds(model, result.bundle, x_cal,
                                loss_type=tcfg.loss_type)
        save_json(dict(cfg_dict), run_dir, "params.json")
        save_bundle(os.path.join(run_dir, "model_bundle.msgpack"), bundle,
                    model)
        save_json({"train_losses": result.train_losses,
                   "val_losses": result.val_losses,
                   "best_epoch": int(result.best_epoch)},
                  run_dir, "losses.json")

        if evaluate is not None:
            metrics = evaluate(model, bundle, x_test, y_test)
        else:
            dec = decide_d2(model, bundle, x_test)
            pred = torch.where(dec.accept, 0, 1)
            n_true = int(np.max(y_test)) + 1
            m = vae_binary_metrics(pred, y_test, n_true, device=pred.device)
            metrics = {"accuracy": float(m.accuracy),
                       "precision": float(m.precision),
                       "recall": float(m.recall), "f1": float(m.f1),
                       "mean_false_acceptance":
                           float(m.mean_false_acceptance)}
        metrics = {**metrics, "run": i,
                   "best_val_loss": float(np.min(result.val_losses))}
        save_json(metrics, run_dir, "metrics.json")
        results.append(metrics)
        if verbose:
            print(f"[sweep] run_{i:04d}: {metrics}")

    save_json([dict(c) for c in configs], out_dir, "all_params.json")
    save_json(results, out_dir, "all_metrics.json")
    return results


# ---------------------------------------------------------------------------
# Stacked config-batch training: C trajectories as one module.
# ---------------------------------------------------------------------------


def stacked_epochs(smodel, opt: StackedAdam, cfg: TrainConfig, betas, seeds,
                   xc_std, xv_std, spec=None, epoch_offset: int = 0):
    """The stacked epoch loop of ``train_vae``: C configs, each on its own
    streams.  ``xc_std`` and ``xv_std`` are each config's standardized
    sets, C tensors (N, L) and (M, L) (one tensor C times where the
    configs share them), ``betas`` C floats, ``seeds`` config c's
    ``train_vae`` seed, ``spec`` None or C (mean, std) pairs.

    Per config and global epoch, the generator ``epoch_generator(s_c,
    epoch)`` draws what ``train_vae``'s does, in its order: the batch
    permutation, each step's noise and dropout masks, the validation
    noise.  The best checkpoint is per config (strict ``<`` against an
    initial ``inf``: NaN and skipped validations never win), an index copy
    of the configs that improved.  Returns (train_losses (C, E), val_losses
    (C, E), best_epoch (C,) without the offset, the best state dict).
    """
    n_cfg, n = len(xc_std), xc_std[0].shape[0]
    k = smodel.latent_dim
    bs = cfg.batch_size
    device, dtype = xc_std[0].device, xc_std[0].dtype
    step = make_stacked_train_step(smodel, opt, cfg, betas, spec)
    eval_loss = make_stacked_eval_loss(smodel, cfg, betas, spec)

    def noise(gens, m):
        return torch.stack([torch.randn((m, k), generator=g, device=device,
                                        dtype=dtype) for g in gens])

    best_val = np.full(n_cfg, np.inf)
    best_epoch = np.zeros(n_cfg, np.int64)
    best_state = _clone_state(smodel)
    train_losses, val_losses = [], []
    for e in range(cfg.epochs):
        epoch = epoch_offset + e
        gens = [epoch_generator(s, epoch, device) for s in seeds]
        smodel.dropout_generators = gens
        idx = [batch_indices(g, n, bs, device) for g in gens]
        losses = [step([x[i[s]] for x, i in zip(xc_std, idx)],
                       noise(gens, bs)) for s in range(idx[0].shape[0])]
        train_losses.append(torch.stack(losses).mean(0))
        if (epoch + 1) % cfg.val_every == 0:
            val = eval_loss(xv_std, noise(gens, xv_std[0].shape[0]))
            val = val.double().cpu().numpy()
        else:
            val = np.full(n_cfg, np.inf)
        val_losses.append(val)
        improved = val < best_val
        if improved.any():
            sel = torch.as_tensor(np.flatnonzero(improved), device=device)
            for key, v in smodel.state_dict().items():
                best_state[key].index_copy_(0, sel, v.index_select(0, sel))
            best_val = np.where(improved, val, best_val)
            best_epoch[improved] = e
    smodel.dropout_generators = None
    smodel.train()
    tl = (torch.stack(train_losses, 1).cpu().numpy() if train_losses
          else np.zeros((n_cfg, 0)))
    vl = np.stack(val_losses, 1) if val_losses else np.zeros((n_cfg, 0))
    return tl, vl, best_epoch, best_state


def _stacked_run(model: ConvVAE1D, cfg: TrainConfig, lrs, weight_decays,
                 betas, seeds, xc_std, xv_std, spec, init_state,
                 epoch_offset):
    """Build (or resume) the stacked model and optimizer, run the epochs,
    and return (tl, vl, best_epoch, best_state, final_state, opt_state)."""
    device, dtype = xc_std[0].device, xc_std[0].dtype
    if init_state is None:
        states, opt_state = [seeded_vae(model, s) for s in seeds], None
    else:
        states, opt_state = init_state
    smodel = stacked_vae(model, states, device=device, dtype=dtype)
    opt = StackedAdam(smodel, lrs, weight_decays)
    if opt_state is not None:
        opt.load_state_dict(opt_state)
    tl, vl, best_epoch, best_state = stacked_epochs(
        smodel, opt, cfg, betas, seeds, xc_std, xv_std, spec, epoch_offset)
    return (tl, vl, best_epoch, best_state, _clone_state(smodel),
            opt.state_dict())


def sweep_prep(x_cal, x_val, lrs, weight_decays, betas, epochs: int,
               batch_size: int, loss_type: str, loss_space: str,
               val_every: int, spec_stats, seed, cfg_seeds, device=None):
    """Shared config-sweep prologue: validation, standardization on the
    device, the run's ``TrainConfig`` (its lr, weight decay and beta are
    placeholders: each config's come as arrays) and the per-config seeds
    (``config_seed(seed, c)`` unless ``cfg_seeds`` are given).

    Returns ``(lrs, weight_decays, betas, cfg_seeds, xc_std, xv_std, mean,
    std, cfg)``; ``xc_std``/``xv_std`` hold the one standardized set C
    times."""
    lrs = [float(v) for v in lrs]
    weight_decays = [float(v) for v in weight_decays]
    betas = [float(v) for v in betas]
    n_cfg = len(lrs)
    if n_cfg < 1 or len(weight_decays) != n_cfg or len(betas) != n_cfg:
        raise ValueError("lrs/weight_decays/betas must share their length "
                         "(at least one config)")
    if cfg_seeds is None:
        cfg_seeds = [config_seed(seed, c) for c in range(n_cfg)]
    cfg_seeds = [int(s) for s in cfg_seeds]
    if len(cfg_seeds) != n_cfg:
        raise ValueError(f"{len(cfg_seeds)} cfg_seeds for {n_cfg} configs")
    device = resolve_device(device, x_cal)
    dtype = _dtype_of(x_cal, device, "train_vae_vmapped")
    mean, std = spectral_stats(x_cal) if spec_stats is None else spec_stats
    mean = torch.as_tensor(mean, dtype=dtype, device=device)
    std = torch.as_tensor(std, dtype=dtype, device=device)
    xc = (torch.as_tensor(x_cal, dtype=dtype, device=device) - mean) / std
    xv = (torch.as_tensor(x_val, dtype=dtype, device=device) - mean) / std
    cfg = TrainConfig(epochs=epochs, batch_size=min(batch_size, xc.shape[0]),
                      loss_type=loss_type, val_every=val_every,
                      loss_space=loss_space)
    return (lrs, weight_decays, betas, cfg_seeds, [xc] * n_cfg, [xv] * n_cfg,
            mean, std, cfg)


def _stacked_bundles(best_state, means, stds, latent_dim):
    n = next(iter(best_state.values())).shape[0]
    return stack_bundles([new_bundle(unstack_state(best_state, c), means[c],
                                     stds[c], latent_dim) for c in range(n)])


def sweep_result(out, mean, std, model: ConvVAE1D,
                 epoch_offset: int) -> TrainResult:
    """Shared config-sweep epilogue: the per-config bundles stacked as
    ``stack_bundles`` stacks them (the shared spectral statistics repeated
    per config, as JAX's vmap broadcasts them) and the ``TrainResult``,
    every field with a leading config axis."""
    tl, vl, best_epoch, best_state, final_state, opt_state = out
    n = tl.shape[0]
    bundle = _stacked_bundles(best_state, [mean] * n, [std] * n,
                              model.latent_dim)
    return TrainResult(bundle, tl, vl, best_epoch + epoch_offset,
                       final_state, opt_state)


def train_vae_vmapped(model: ConvVAE1D, x_cal, x_val, lrs, weight_decays,
                      betas, epochs: int, batch_size: int, loss_type: str,
                      seed: int = 0, spec_stats=None,
                      loss_space: str = "std", val_every: int = 1,
                      init_state=None, epoch_offset: int = 0,
                      cfg_seeds=None, device=None) -> TrainResult:
    """Train ``len(lrs)`` configs of ``model``'s architecture at once, as
    one ``StackedVAE`` (``ocm_tpu``'s vmapped trainer).

    The configs share the data, the epoch schedule and the loss; lr,
    weight decay and beta vary per config.  Config c runs what
    ``train_vae(seeded_vae(model, s_c), x_cal, x_val, TrainConfig(lr=
    lrs[c], weight_decay=weight_decays[c], beta=betas[c], ...),
    seed=s_c)`` runs, with ``s_c = cfg_seeds[c]`` or by default
    ``config_seed(seed, c)``: the same initial weights, random streams and
    best-epoch rule.  ``model`` gives the architecture; its own weights
    are not used.  A config that diverges (NaN) leaves the others as they
    would be alone.

    Resume: ``init_state=(final_state, final_opt_state)`` of an earlier
    result and ``epoch_offset`` (its epochs) continue every config's
    weights, Adam state and streams.  The run goes to ``device``, else the
    device of a tensor ``x_cal``, else CUDA, in float64 for float64 inputs
    on the CPU and float32 otherwise (``trainer._dtype_of``).

    Returns a ``TrainResult`` with a leading config axis: the bundles of
    each config's best epoch stacked as ``stack_bundles`` stacks them,
    train and val losses (C, epochs), best epochs (C,), the stacked final
    state dict and the ``StackedAdam`` state.
    """
    (lrs, weight_decays, betas, cfg_seeds, xc_std, xv_std, mean, std,
     cfg) = sweep_prep(x_cal, x_val, lrs, weight_decays, betas, epochs,
                       batch_size, loss_type, loss_space, val_every,
                       spec_stats, seed, cfg_seeds, device)
    spec = [(mean, std)] * len(lrs) if loss_space == "raw" else None
    out = _stacked_run(model, cfg, lrs, weight_decays, betas, cfg_seeds,
                       xc_std, xv_std, spec, init_state, epoch_offset)
    return sweep_result(out, mean, std, model, epoch_offset)


def classes_prep(x_cals, x_vals, spec_stats=None):
    """Shared per-class prep: validate, standardize each class by its OWN
    stats (the reference semantics), cyclic-pad unequal class sizes to the
    largest, stack.  Returns ``(xcs, xvs, means, stds, n_max)`` as stacked
    numpy arrays with a leading class axis (``ocm_tpu``'s, bit for bit)."""
    n_classes = len(x_cals)
    if n_classes < 1 or len(x_vals) != n_classes:
        raise ValueError(
            "x_cals and x_vals must be equal-length and non-empty")
    x_cals = [np.asarray(x) for x in x_cals]
    x_vals = [np.asarray(x) for x in x_vals]
    for i, (xc, xv) in enumerate(zip(x_cals, x_vals)):
        if xc.shape[0] == 0 or xv.shape[0] == 0:
            raise ValueError(
                f"class {i}: empty calibration or validation set "
                f"(shapes {xc.shape} / {xv.shape})")
    lengths = ({x.shape[1] for x in x_cals}
               | {x.shape[1] for x in x_vals})
    if len(lengths) != 1:
        raise ValueError("classes must share one spectral length, got "
                         f"{sorted(lengths)}")
    if spec_stats is None:
        stats = [spectral_stats(x) for x in x_cals]
    else:
        stats = [tuple(s) for s in spec_stats]
        if len(stats) != n_classes:
            raise ValueError("spec_stats must give (mean, std) per class")
    n_max = max(x.shape[0] for x in x_cals)
    m_max = max(x.shape[0] for x in x_vals)
    xcs, xvs, means, stds = [], [], [], []
    for xc, xv, (mean, std) in zip(x_cals, x_vals, stats):
        mean = np.asarray(mean, xc.dtype)
        std = np.asarray(std, xc.dtype)
        xcs.append(cyclic_pad_to((xc - mean) / std, n_max))
        xvs.append(cyclic_pad_to((xv - mean) / std, m_max))
        means.append(mean)
        stds.append(std)
    return (np.stack(xcs), np.stack(xvs), np.stack(means),
            np.stack(stds), n_max)


def classes_result(out, means, stds, model: ConvVAE1D) -> TrainResult:
    """Shared per-class epilogue: the classes' bundles, each with its own
    spectral statistics, stacked exactly as ``stack_bundles`` stacks them,
    and the ``TrainResult`` with a leading class axis."""
    tl, vl, best_epoch, best_state, final_state, opt_state = out
    bundle = _stacked_bundles(best_state, means, stds, model.latent_dim)
    return TrainResult(bundle, tl, vl, best_epoch, final_state, opt_state)


def train_vae_classes(model: ConvVAE1D, x_cals, x_vals, cfg: TrainConfig,
                      seed: int = 0, spec_stats=None,
                      device=None) -> TrainResult:
    """Train one VAE per CLASS (one architecture, per-class data) as one
    ``StackedVAE``.

    Each class has its own calibration and validation sets, standardized by
    its own ``spectral_stats`` (or ``spec_stats[c]``), and its own seed
    ``config_seed(seed, c)`` (initial weights and streams, as in
    ``train_vae_vmapped``); ``cfg``'s lr, weight decay and beta are
    shared.  Unequal class sizes are CYCLIC-padded to the largest (JAX's
    padding): a smaller class trains on a cyclically oversampled set, and
    a class at the largest size runs exactly ``train_vae(seeded_vae(model,
    s_c), x_cals[c], x_vals[c], cfg, seed=s_c)``.

    Returns a ``TrainResult`` with a leading class axis; ``result.bundle``
    is stacked exactly as ``models.bundle.stack_bundles`` stacks, so after
    per-class ``vae_decision.fit_thresholds`` (on ``class_slice(
    result.bundle, c)``) the re-stacked models feed the multi-class
    ``serving.VAEScorer``.
    """
    xcs, xvs, means, stds, n_max = classes_prep(x_cals, x_vals, spec_stats)
    device = resolve_device(device, x_cals[0])
    dtype = _dtype_of(x_cals[0], device, "train_vae_classes")
    means_t, stds_t, out = classes_run(model, cfg, seed, xcs, xvs, means,
                                       stds, n_max, range(xcs.shape[0]),
                                       device, dtype)
    return classes_result(out, means_t, stds_t, model)


def classes_run(model: ConvVAE1D, cfg: TrainConfig, seed: int, xcs, xvs,
                means, stds, n_max: int, classes, device, dtype):
    """The stacked run of ``classes`` (indices into ``classes_prep``'s
    stacked sets; class c seeded ``config_seed(seed, c)``) on ``device``:
    ``(means, stds, out)``, every class's statistics as tensors and
    ``_stacked_run``'s output for the chosen classes."""
    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    classes = list(classes)
    means_t, stds_t = dev(means), dev(stds)
    spec = ([(means_t[c], stds_t[c]) for c in classes]
            if cfg.loss_space == "raw" else None)
    tcfg = TrainConfig(epochs=cfg.epochs,
                       batch_size=min(cfg.batch_size, n_max),
                       loss_type=cfg.loss_type, val_every=cfg.val_every,
                       loss_space=cfg.loss_space)
    n = len(classes)
    out = _stacked_run(model, tcfg, [cfg.lr] * n, [cfg.weight_decay] * n,
                       [cfg.beta] * n, [config_seed(seed, c) for c in classes],
                       [dev(xcs[c]) for c in classes],
                       [dev(xvs[c]) for c in classes], spec, None, 0)
    return means_t, stds_t, out


# ---------------------------------------------------------------------------
# HPO: Optuna hook (optional dep) + dependency-free random search.
# ---------------------------------------------------------------------------

SEARCH_SPACE_DEFAULT = {
    # the reference's Optuna space (optim_bce_nuts.py:118-126)
    "latent_dim": ("int", 4, 64),
    "lr": ("loguniform", 1e-4, 1e-2),
    "beta": ("loguniform", 1e-3, 4.0),
    "batch_size": ("categorical", [32, 64, 128]),
}


def sample_config(space: Mapping, rng: np.random.Generator) -> dict:
    out = {}
    for k, spec in space.items():
        kind = spec[0]
        if kind == "int":
            out[k] = int(rng.integers(spec[1], spec[2] + 1))
        elif kind == "uniform":
            out[k] = float(rng.uniform(spec[1], spec[2]))
        elif kind == "loguniform":
            out[k] = float(np.exp(rng.uniform(np.log(spec[1]),
                                              np.log(spec[2]))))
        elif kind == "categorical":
            out[k] = spec[1][int(rng.integers(len(spec[1])))]
        else:
            raise ValueError(f"unknown search-space kind {kind!r}")
    return out


def random_search(objective: Callable[[dict], float], space: Mapping,
                  n_trials: int, seed: int = 42, maximize: bool = True):
    """Dependency-free HPO: seeded random search over the space.

    Returns (best_config, best_value, history).  Stands in for the
    reference's Optuna TPE study (optim_bce_nuts.py:286-307) when optuna is
    unavailable.
    """
    rng = np.random.default_rng(seed)
    best_cfg, best_val, history = None, None, []
    for t in range(n_trials):
        cfg = sample_config(space, rng)
        val = float(objective(cfg))
        history.append({"trial": t, "config": cfg, "value": val})
        better = (best_val is None or
                  (val > best_val if maximize else val < best_val))
        if better:
            best_cfg, best_val = cfg, val
    return best_cfg, best_val, history


def _take(tree, j: int):
    """A copy of entry ``j`` of the leading axis of a stacked state (dicts,
    tuples, bundles, tensors; a count shared by the stack stays as it is),
    so that the stack itself can be freed."""
    if isinstance(tree, dict):
        return {k: _take(v, j) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_take(v, j) for v in tree)) \
            if hasattr(tree, "_fields") else tuple(_take(v, j) for v in tree)
    if isinstance(tree, (int, float)):
        return tree
    return tree[j].clone()


def _restack(states):
    """Per-trial ``(state, opt_state)`` pairs -> one stacked pair."""
    def stack(trees):
        t0 = trees[0]
        if isinstance(t0, dict):
            return {k: stack([t[k] for t in trees]) for k in t0}
        if isinstance(t0, tuple):
            return tuple(stack(list(ts)) for ts in zip(*trees))
        if isinstance(t0, (int, float)):
            if any(t != t0 for t in trees):
                raise ValueError("survivors of one group stepped apart")
            return t0
        return torch.stack(list(trees))
    return stack(list(states))


def asha_vae_search(x_cal, x_val, space: Mapping = None, n_trials: int = 9,
                    max_epochs: int = 27, reduction: int = 3,
                    min_epochs: Optional[int] = None, seed: int = 42,
                    base_config: Optional[Mapping] = None,
                    configs: Optional[Sequence[Mapping]] = None,
                    mesh=None, verbose: bool = True, device=None) -> dict:
    """Dependency-free adaptive HPO: successive halving (the synchronous
    core of ASHA) over the stacked trainer.

    Every trial trains ``min_epochs`` first; at each rung boundary the
    bottom (1 - 1/reduction) of trials by best validation loss are KILLED
    (their states freed) and the survivors continue from their exact
    weights, Adam moments and streams.  Within a rung, the trials sharing
    an architecture (and batch size and loss) train as one
    ``train_vae_vmapped`` call, re-stacked from the survivors' states.
    Trial t's seed is ``config_seed(seed, t)`` (``ocm_tpu`` folds t into
    its master key).

    ``space`` defaults to SEARCH_SPACE_DEFAULT.  Config keys: latent_dim,
    conv_blocks, n_filters, kernel_size, hidden_fc, dropout, activation,
    batch_size, loss_type, lr, weight_decay, beta.  Minimizes the best
    validation loss.  ``configs`` (optional) is an explicit cohort (each
    merged over ``base_config``) in place of ``n_trials`` samples.
    ``mesh`` (a ``parallel.mesh.Mesh`` with a ``'model'`` axis): fresh
    rungs train config-sharded across its ranks
    (``parallel.sweep_dist.train_vae_vmapped_sharded``, the same
    trajectories as the local stacked run); later rungs resume locally on
    ``mesh.device``, as in the reference.

    Returns ``{"best_config", "best_value", "best_bundle", "history",
    "total_epochs", "rungs", "trials"}`` as ``ocm_tpu`` does.
    """
    if mesh is not None:
        from ocm_tpu_torch.parallel.mesh import MODEL_AXIS, require_mesh_axis
        from ocm_tpu_torch.parallel.sweep_dist import (
            train_vae_vmapped_sharded)

        require_mesh_axis(mesh, MODEL_AXIS)
        device = mesh.device if device is None else device
    if reduction < 2:
        raise ValueError(f"reduction must be >= 2, got {reduction}")
    if n_trials < 1 or max_epochs < 1:
        raise ValueError("n_trials and max_epochs must be >= 1")
    if min_epochs is not None and not 1 <= min_epochs <= max_epochs:
        raise ValueError(
            f"min_epochs must be in [1, max_epochs], got {min_epochs}")
    if space is None:
        space = SEARCH_SPACE_DEFAULT
    host_rng = np.random.default_rng(seed)
    base_config = dict(base_config or {})
    if configs is not None:
        if not configs:
            raise ValueError("configs must be a non-empty sequence")
        n_trials = len(configs)
        sampled = [dict(c) for c in configs]
    else:
        sampled = [sample_config(space, host_rng) for _ in range(n_trials)]
    trials = [{"id": t, "config": {**base_config, **sampled[t]},
               "best_val": np.inf, "bundle": None, "state": None,
               "epochs": 0}
              for t in range(n_trials)]

    if min_epochs is None:
        k0 = max(1, math.ceil(math.log(max(n_trials, reduction))
                              / math.log(reduction)))
        min_epochs = max(1, max_epochs // reduction ** k0)
    rungs = []
    r = min_epochs
    while r < max_epochs:
        rungs.append(r)
        r *= reduction
    rungs.append(max_epochs)

    input_length = int(np.shape(x_cal)[1])
    spec_stats = spectral_stats(x_cal)

    def arch_of(c):
        return (int(c.get("latent_dim", 16)), int(c.get("conv_blocks", 3)),
                int(c.get("n_filters", 32)), int(c.get("kernel_size", 9)),
                int(c.get("hidden_fc", 256)), float(c.get("dropout", 0.0)),
                c.get("activation", "elu"), int(c.get("batch_size", 64)),
                c.get("loss_type", "cosine"))

    alive = list(trials)
    history = []
    total_epochs = 0
    for rung_i, target in enumerate(rungs):
        delta = target - alive[0]["epochs"]
        groups: dict = {}
        for tr in alive:
            groups.setdefault(arch_of(tr["config"]), []).append(tr)
        for arch, grp in groups.items():
            model = vae_from_config(input_length, grp[0]["config"])
            cfgs = [tr["config"] for tr in grp]
            init = None
            if grp[0]["state"] is not None:
                init = _restack([tr["state"] for tr in grp])
            grp_lrs = [float(c.get("lr", 1e-3)) for c in cfgs]
            grp_wds = [float(c.get("weight_decay", 0.0)) for c in cfgs]
            grp_betas = [float(c.get("beta", 1.0)) for c in cfgs]
            seeds = [config_seed(seed, tr["id"]) for tr in grp]
            if mesh is not None and init is None:
                # the sharded trainer runs fresh trajectories only, from
                # epoch 0: safe at the first rung alone
                if grp[0]["epochs"] != 0:
                    raise AssertionError(
                        "sharded rung reached with trained trials but no "
                        "resume state — would restart trajectories")
                res = train_vae_vmapped_sharded(
                    model, x_cal, x_val, grp_lrs, grp_wds, grp_betas, mesh,
                    epochs=delta, batch_size=arch[7], loss_type=arch[8],
                    spec_stats=spec_stats, cfg_seeds=seeds)
            else:
                res = train_vae_vmapped(
                    model, x_cal, x_val, grp_lrs, grp_wds, grp_betas,
                    epochs=delta, batch_size=arch[7], loss_type=arch[8],
                    spec_stats=spec_stats, cfg_seeds=seeds, init_state=init,
                    epoch_offset=grp[0]["epochs"], device=device)
            vls = np.asarray(res.val_losses)            # (n_grp, delta)
            for j, tr in enumerate(grp):
                tr["epochs"] = target
                v = float(np.min(vls[j]))
                if np.isfinite(v) and v < tr["best_val"]:
                    tr["best_val"] = v
                    tr["bundle"] = _take(res.bundle, j)
                tr["state"] = _take((res.final_state, res.final_opt_state),
                                    j)
            total_epochs += delta * len(grp)

        alive.sort(key=lambda tr: tr["best_val"])
        last_rung = rung_i == len(rungs) - 1
        keep = len(alive) if last_rung else max(
            1, math.ceil(len(alive) / reduction))
        killed, alive = alive[keep:], alive[:keep]
        for tr in killed:
            # a killed trial never trains again and cannot win: free its
            # device state and bundle for the rest of the search
            tr["state"] = None
            tr["bundle"] = None
        history.append({
            "rung": rung_i, "epochs": target,
            "alive": [tr["id"] for tr in alive],
            "killed": [tr["id"] for tr in killed],
            "values": {tr["id"]: tr["best_val"] for tr in alive + killed}})
        if verbose:
            print(f"[asha] rung {rung_i} @ {target} ep: "
                  f"kept {len(alive)}, killed {len(killed)}, "
                  f"best={alive[0]['best_val']:.5f}")
        if len(alive) == 1 and last_rung:
            break

    best = alive[0]
    if best["bundle"] is None:
        raise RuntimeError(
            "asha_vae_search: no trial produced a finite validation loss "
            "(all trajectories diverged) — widen/lower the lr range or "
            "check the loss_type against the data scale")
    return {"best_config": dict(best["config"]),
            "best_value": best["best_val"],
            "best_bundle": best["bundle"], "history": history,
            "total_epochs": total_epochs, "rungs": rungs,
            "trials": [{"id": tr["id"], "config": dict(tr["config"]),
                        "best_val": tr["best_val"], "epochs": tr["epochs"]}
                       for tr in sorted(trials, key=lambda tr: tr["id"])]}


def pruning_report(trial) -> Callable:
    """Per-epoch pruning callback for ``train_vae_blocked`` from an
    Optuna-style trial — the reference's mid-trial protocol
    (``trial.report(loss, epoch)`` then prune, optim_bce_nuts.py:197-199).

    Works with any object exposing ``report(value, step)`` and
    ``should_prune() -> bool``.  Usage::

        from ocm_tpu_torch.models.trainer import train_vae_blocked
        r = train_vae_blocked(model, x_cal, x_val, cfg, seed,
                              block_epochs=1, report=pruning_report(trial))
    """
    def report(epoch: int, train_loss: float, val_loss: float) -> bool:
        trial.report(val_loss, epoch)
        return bool(trial.should_prune())
    return report


def optuna_objective(objective: Callable[[dict], float], space: Mapping):
    """Wrap a config-dict objective as an Optuna objective (lazy import;
    mirrors trial.suggest_* usage of optim_bce_nuts.py:118-126)."""
    def _objective(trial):
        cfg = {}
        for k, spec in space.items():
            kind = spec[0]
            if kind == "int":
                cfg[k] = trial.suggest_int(k, spec[1], spec[2])
            elif kind == "uniform":
                cfg[k] = trial.suggest_float(k, spec[1], spec[2])
            elif kind == "loguniform":
                cfg[k] = trial.suggest_float(k, spec[1], spec[2], log=True)
            elif kind == "categorical":
                cfg[k] = trial.suggest_categorical(k, list(spec[1]))
            else:
                raise ValueError(f"unknown search-space kind {kind!r}")
        return objective(cfg)
    return _objective


def run_optuna_study(objective: Callable[[dict], float], space: Mapping,
                     n_trials: int = 50, seed: int = 42,
                     direction: str = "maximize"):
    """Reference-equivalent Optuna study (TPESampler(seed) + MedianPruner,
    optim_bce_nuts.py:286-292).  Raises ImportError when optuna is absent —
    use ``random_search`` then."""
    try:
        import optuna
    except ImportError as e:
        raise ImportError(
            "optuna is not installed; use "
            "ocm_tpu_torch.utils.sweep.random_search for the "
            "dependency-free HPO path") from e
    study = optuna.create_study(
        direction=direction,
        sampler=optuna.samplers.TPESampler(seed=seed),
        pruner=optuna.pruners.MedianPruner(n_warmup_steps=10))
    study.optimize(optuna_objective(objective, space), n_trials=n_trials)
    return study
