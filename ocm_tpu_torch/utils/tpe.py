"""Dependency-free TPE sampler + median pruner: the adaptive half of the
reference's HPO protocol without optuna.

Port of ``ocm_tpu/utils/tpe.py``.  The reference's study is
``optuna.create_study(sampler=TPESampler(seed=42),
pruner=MedianPruner(n_warmup_steps=10))`` driven by per-epoch
``trial.report``/``should_prune`` (optim_bce_nuts.py:286-292, :197-199).

- :class:`TPESampler` (Tree-structured Parzen Estimator) and
  :class:`MedianPruner` are the JAX package's plain numpy, copied: one
  seed and one told history give the same suggestions, bit for bit.
- :func:`tpe_search`: ``sweep.random_search``'s contract with TPE sampling.
- :func:`tpe_vae_search`: TPE sampling + per-epoch median pruning over the
  port's ``train_vae_blocked`` (each trial a ``seeded_vae`` trained with
  seed ``config_seed(seed, t)``), returning the best bundle.
- :func:`bohb_vae_search`: TPE samples each bracket's cohort,
  ``sweep.asha_vae_search`` trains it with stacked rungs.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional

import numpy as np

__all__ = ["TPESampler", "MedianPruner", "tpe_search", "tpe_vae_search",
           "bohb_vae_search"]


# ---------------------------------------------------------------------------
# Parzen helpers (host-side NumPy: HPO bookkeeping, never device work)
# ---------------------------------------------------------------------------


def _parzen(points: np.ndarray, lo: float, hi: float):
    """Build a 1-D Parzen mixture over [lo, hi] from observed points.

    Mixture components: one Gaussian per observation plus a wide prior
    Gaussian at the interval midpoint (keeps the density proper when few
    points exist and preserves exploration).  Bandwidths follow the classic
    TPE heuristic: the distance to the farther adjacent point in sorted
    order, clipped to [(hi-lo)/100, hi-lo].
    """
    width = hi - lo
    mus = np.sort(np.asarray(points, dtype=np.float64))
    if mus.size == 0:
        return np.array([0.5 * (lo + hi)]), np.array([width])
    ext = np.concatenate([[lo], mus, [hi]])
    left = ext[1:-1] - ext[:-2]
    right = ext[2:] - ext[1:-1]
    sigmas = np.clip(np.maximum(left, right), width / 100.0, width)
    mus = np.concatenate([mus, [0.5 * (lo + hi)]])
    sigmas = np.concatenate([sigmas, [width]])
    return mus, sigmas


def _parzen_logpdf(x: np.ndarray, mus: np.ndarray,
                   sigmas: np.ndarray) -> np.ndarray:
    """log density of the equal-weight Gaussian mixture at each x."""
    z = (x[:, None] - mus[None, :]) / sigmas[None, :]
    comp = -0.5 * z * z - np.log(sigmas[None, :] * math.sqrt(2 * math.pi))
    m = comp.max(axis=1, keepdims=True)
    return (m[:, 0] + np.log(np.mean(np.exp(comp - m), axis=1)))


def _parzen_sample(rng: np.random.Generator, n: int, mus: np.ndarray,
                   sigmas: np.ndarray, lo: float, hi: float) -> np.ndarray:
    idx = rng.integers(len(mus), size=n)
    return np.clip(rng.normal(mus[idx], sigmas[idx]), lo, hi)


class TPESampler:
    """Tree-structured Parzen Estimator over a ``sweep``-style search space.

    ``space`` maps parameter name -> spec tuple, identical to
    ``sweep.sample_config``:

    - ``("int", lo, hi)`` (inclusive), ``("uniform", lo, hi)``,
      ``("loguniform", lo, hi)`` — Parzen densities (log-domain for
      loguniform, rounded for int);
    - ``("categorical", [choices])`` — Laplace-smoothed frequency ratio.

    Protocol: ``suggest() -> config``, then ``tell(config, value)`` once
    the objective is known; the first ``n_startup_trials`` suggestions are
    pure random (the reference sampler's warm-up), after which candidates
    maximize the good/bad density ratio.  ``maximize`` sets which direction
    "good" means; optuna's TPESampler defaults are mirrored where they
    matter (gamma ~ 25% capped at 25 observations, 24 EI candidates).
    """

    def __init__(self, space: Mapping, seed: int = 42,
                 n_startup_trials: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, maximize: bool = False):
        for k, spec in space.items():
            if spec[0] not in ("int", "uniform", "loguniform", "categorical"):
                raise ValueError(
                    f"unknown search-space kind {spec[0]!r} for {k!r}")
        if not 0.0 < gamma < 1.0:
            raise ValueError(f"gamma must be in (0, 1), got {gamma}")
        self.space = dict(space)
        self.rng = np.random.default_rng(seed)
        self.n_startup_trials = int(n_startup_trials)
        self.gamma = float(gamma)
        self.n_candidates = int(n_candidates)
        self.maximize = bool(maximize)
        self._configs: list[dict] = []
        self._values: list[float] = []

    # -- observation bookkeeping -------------------------------------------
    def tell(self, config: Mapping, value: float) -> None:
        self._configs.append(dict(config))
        self._values.append(float(value))

    def _split(self):
        """Indices of good / bad observed trials (non-finite values are
        always bad: a diverged VAE run must not seed the good density)."""
        vals = np.asarray(self._values, dtype=np.float64)
        order = np.argsort(-vals if self.maximize else vals, kind="stable")
        finite = np.isfinite(vals[order])
        order = np.concatenate([order[finite], order[~finite]])
        n_good = max(1, min(25, math.ceil(self.gamma * len(vals))))
        n_good = min(n_good, int(finite.sum())) or 1
        return order[:n_good], order[n_good:]

    # -- sampling ----------------------------------------------------------
    def suggest(self) -> dict:
        from ocm_tpu_torch.utils.sweep import sample_config

        if len(self._values) < self.n_startup_trials or \
                not np.isfinite(self._values).any():
            return sample_config(self.space, self.rng)
        good, bad = self._split()
        out = {}
        for name, spec in self.space.items():
            kind = spec[0]
            gvals = [self._configs[i][name] for i in good
                     if name in self._configs[i]]
            bvals = [self._configs[i][name] for i in bad
                     if name in self._configs[i]]
            if kind == "categorical":
                out[name] = self._suggest_categorical(spec[1], gvals, bvals)
            else:
                out[name] = self._suggest_numeric(spec, gvals, bvals)
        return out

    def _suggest_numeric(self, spec, gvals, bvals):
        kind, lo, hi = spec[0], float(spec[1]), float(spec[2])
        fwd = np.log if kind == "loguniform" else np.asarray
        xlo, xhi = float(fwd(lo)), float(fwd(hi))
        g_mu, g_sig = _parzen(fwd(np.asarray(gvals, np.float64)), xlo, xhi)
        b_mu, b_sig = _parzen(fwd(np.asarray(bvals, np.float64)), xlo, xhi)
        cand = _parzen_sample(self.rng, self.n_candidates, g_mu, g_sig,
                              xlo, xhi)
        score = (_parzen_logpdf(cand, g_mu, g_sig)
                 - _parzen_logpdf(cand, b_mu, b_sig))
        x = float(cand[int(np.argmax(score))])
        if kind == "loguniform":
            return float(min(max(math.exp(x), lo), hi))
        if kind == "int":
            return int(min(max(round(x), int(lo)), int(hi)))
        return float(x)

    def _suggest_categorical(self, choices, gvals, bvals):
        choices = list(choices)

        def probs(vals):
            counts = np.array([1.0 + sum(v == c for v in vals)
                               for c in choices])
            return counts / counts.sum()

        pg, pb = probs(gvals), probs(bvals)
        # draw candidates from the good distribution, rank by ratio —
        # stochastic like optuna's sampler, so exploration survives
        idx = self.rng.choice(len(choices), size=self.n_candidates, p=pg)
        ratio = pg[idx] / pb[idx]
        return choices[int(idx[int(np.argmax(ratio))])]


# ---------------------------------------------------------------------------
# Median pruner
# ---------------------------------------------------------------------------


class MedianPruner:
    """optuna's ``MedianPruner(n_warmup_steps)`` rule, standalone.

    ``report(trial_id, step, value)`` records an intermediate value (for
    the VAE protocol: the per-epoch validation loss).  ``should_prune``
    answers: at the trial's latest reported step ``s``, is its best value
    so far worse than the median of every OTHER trial's reported value at
    the same step?  Steps below ``n_warmup_steps`` never prune
    (optim_bce_nuts.py:289 uses ``n_warmup_steps=10``), and at least
    ``n_min_trials`` other trials must have reached the step.
    """

    def __init__(self, n_warmup_steps: int = 10, n_min_trials: int = 1,
                 maximize: bool = False):
        self.n_warmup_steps = int(n_warmup_steps)
        self.n_min_trials = int(n_min_trials)
        self.maximize = bool(maximize)
        self._reports: dict = {}          # trial_id -> {step: value}

    def report(self, trial_id, step: int, value: float) -> None:
        self._reports.setdefault(trial_id, {})[int(step)] = float(value)

    def should_prune(self, trial_id) -> bool:
        mine = self._reports.get(trial_id)
        if not mine:
            return False
        step = max(mine)
        if step < self.n_warmup_steps:
            return False
        finite = [v for v in mine.values() if np.isfinite(v)]
        if not np.isfinite(mine[step]) or not finite:
            return True                       # diverged: always prune
        others = [r[step] for tid, r in self._reports.items()
                  if tid != trial_id and step in r
                  and np.isfinite(r[step])]
        if len(others) < self.n_min_trials:
            return False
        best = max(finite) if self.maximize else min(finite)
        med = float(np.median(others))
        return best < med if self.maximize else best > med

    def trial_callback(self, trial_id):
        """Adapter to ``train_vae_blocked``'s ``report(epoch, train, val)``
        hook: records the epoch's validation loss and returns the prune
        decision (the reference's trial.report + should_prune pair,
        optim_bce_nuts.py:197-199)."""
        def _cb(epoch: int, train_loss: float, val_loss: float) -> bool:
            self.report(trial_id, epoch, val_loss)
            return self.should_prune(trial_id)
        return _cb


# ---------------------------------------------------------------------------
# Searches
# ---------------------------------------------------------------------------


def tpe_search(objective: Callable[[dict], float], space: Mapping,
               n_trials: int, seed: int = 42, maximize: bool = True,
               n_startup_trials: int = 10):
    """TPE-sampled sequential HPO; same contract as ``sweep.random_search``
    (returns ``(best_config, best_value, history)``)."""
    sampler = TPESampler(space, seed=seed, maximize=maximize,
                         n_startup_trials=n_startup_trials)
    best_cfg, best_val, history = None, None, []
    for t in range(n_trials):
        cfg = sampler.suggest()
        val = float(objective(cfg))
        sampler.tell(cfg, val)
        history.append({"trial": t, "config": cfg, "value": val})
        better = (best_val is None or
                  (val > best_val if maximize else val < best_val))
        if better and np.isfinite(val):
            best_cfg, best_val = cfg, val
    return best_cfg, best_val, history


def tpe_vae_search(x_cal, x_val, space: Optional[Mapping] = None,
                   n_trials: int = 50, max_epochs: int = 100,
                   seed: int = 42, base_config: Optional[Mapping] = None,
                   block_epochs: int = 1, n_warmup_steps: int = 10,
                   verbose: bool = True, device=None) -> dict:
    """The reference's full HPO protocol, dependency-free: TPE sampling +
    per-epoch median pruning over the blocked trainer.

    Mirrors optim_bce_nuts.py: a study of ``n_trials`` sequential trials
    (TPESampler(seed), MedianPruner(n_warmup_steps)); trial t trains
    ``seeded_vae`` of its architecture with seed ``config_seed(seed, t)``
    (``ocm_tpu`` folds t into its key) for up to ``max_epochs``, reporting
    every epoch (``block_epochs=1`` is the reference cadence).  The
    objective is the best finite validation loss, minimized.  Config keys
    are those of ``asha_vae_search``; ``space`` defaults to
    ``SEARCH_SPACE_DEFAULT``.

    Returns ``{"best_config", "best_value", "best_bundle", "history",
    "total_epochs", "n_pruned"}``; ``total_epochs`` counts the epochs
    trained, to the edge of the block a prune fell in.
    """
    from ocm_tpu_torch.models import trainer
    from ocm_tpu_torch.models.bundle import spectral_stats
    from ocm_tpu_torch.models.stacked import config_seed, seeded_vae
    from ocm_tpu_torch.utils.sweep import (SEARCH_SPACE_DEFAULT,
                                           vae_from_config)

    if n_trials < 1 or max_epochs < 1:
        raise ValueError("n_trials and max_epochs must be >= 1")
    if space is None:
        space = SEARCH_SPACE_DEFAULT
    base_config = dict(base_config or {})
    sampler = TPESampler(space, seed=seed, maximize=False)
    pruner = MedianPruner(n_warmup_steps=n_warmup_steps, maximize=False)
    spec_stats = spectral_stats(x_cal)
    input_length = int(np.shape(x_cal)[1])

    best = {"config": None, "value": np.inf, "bundle": None}
    history = []
    total_epochs = 0
    n_pruned = 0
    for t in range(n_trials):
        cfg = {**base_config, **sampler.suggest()}
        trial_seed = config_seed(seed, t)
        model = seeded_vae(vae_from_config(input_length, cfg), trial_seed)
        tc = trainer.TrainConfig(
            epochs=max_epochs, batch_size=int(cfg.get("batch_size", 64)),
            lr=float(cfg.get("lr", 1e-3)),
            weight_decay=float(cfg.get("weight_decay", 0.0)),
            beta=float(cfg.get("beta", 1.0)),
            loss_type=cfg.get("loss_type", "cosine"))
        res = trainer.train_vae_blocked(model, x_cal, x_val, tc, trial_seed,
                                        block_epochs=block_epochs,
                                        report=pruner.trial_callback(t),
                                        spec_stats=spec_stats, device=device)
        vls = np.asarray(res.val_losses)
        epochs_run = int(vls.shape[0])
        pruned = epochs_run < max_epochs
        n_pruned += int(pruned)
        # epochs trained: a mid-block prune stops the reports, but the
        # block had already run to its edge
        epochs_device = min(max_epochs, -(-epochs_run // block_epochs)
                            * block_epochs)
        total_epochs += epochs_device
        # the best finite loss: a trial whose last epochs diverged still
        # scores by its best finite epoch (the blocked trainer's bundle)
        finite = vls[np.isfinite(vls)]
        value = float(finite.min()) if finite.size else np.inf
        sampler.tell(cfg, value)
        history.append({"trial": t, "config": cfg, "value": value,
                        "epochs": epochs_run,
                        "epochs_device": epochs_device, "pruned": pruned})
        if np.isfinite(value) and value < best["value"] \
                and res.bundle is not None:
            best = {"config": dict(cfg), "value": value,
                    "bundle": res.bundle}
        if verbose:
            tag = "PRUNED" if pruned else "done  "
            print(f"[tpe] trial {t:3d} {tag} @ {epochs_run:3d} ep "
                  f"val={value:.5f} best={best['value']:.5f}")
    if best["bundle"] is None:
        raise RuntimeError(
            "tpe_vae_search: no trial produced a finite validation loss — "
            "widen/lower the lr range or check loss_type vs the data scale")
    return {"best_config": best["config"], "best_value": best["value"],
            "best_bundle": best["bundle"], "history": history,
            "total_epochs": total_epochs, "n_pruned": n_pruned}


def bohb_vae_search(x_cal, x_val, space: Optional[Mapping] = None,
                    n_brackets: int = 3, trials_per_bracket: int = 9,
                    max_epochs: int = 27, reduction: int = 3,
                    seed: int = 42, base_config: Optional[Mapping] = None,
                    mesh=None, verbose: bool = True, device=None) -> dict:
    """BOHB-style HPO (Falkner et al. 2018's combination, simplified): TPE
    sampling ACROSS brackets, stacked successive halving WITHIN each.

    Each bracket's cohort of ``trials_per_bracket`` configs is drawn from
    the :class:`TPESampler` (bracket 0 is the random warm-up) and trained
    by ``sweep.asha_vae_search`` (seed ``seed + b``), whose rungs train
    each architecture group as one stacked module.  After a bracket every
    trial's best validation loss, at whatever budget halving granted it,
    is told back to the sampler.  ``mesh`` (a ``parallel.mesh.Mesh`` with
    a ``'model'`` axis) goes to ``asha_vae_search``: each bracket's fresh
    rungs train config-sharded across its ranks.

    Returns ``{"best_config", "best_value", "best_bundle", "history",
    "total_epochs"}``; ``history`` holds one entry per bracket.
    """
    from ocm_tpu_torch.utils.sweep import (SEARCH_SPACE_DEFAULT,
                                           asha_vae_search, sample_config)

    if n_brackets < 1 or trials_per_bracket < 1:
        raise ValueError("n_brackets and trials_per_bracket must be >= 1")
    if space is None:
        space = SEARCH_SPACE_DEFAULT
    sampler = TPESampler(space, seed=seed, maximize=False,
                         n_startup_trials=trials_per_bracket)
    best = {"config": None, "value": np.inf, "bundle": None}
    history = []
    total_epochs = 0
    for b in range(n_brackets):
        cohort, seen = [], set()
        for _ in range(trials_per_bracket):
            cfg = sampler.suggest()
            # consecutive suggests share one density and can collide;
            # resample randomly until unseen (bounded: a small
            # all-categorical space may hold fewer configs than the cohort)
            for _retry in range(16):
                key = tuple(sorted(cfg.items()))
                if key not in seen:
                    break
                cfg = sample_config(space, sampler.rng)
            seen.add(tuple(sorted(cfg.items())))
            cohort.append(cfg)
        out = asha_vae_search(x_cal, x_val, space,
                              max_epochs=max_epochs, reduction=reduction,
                              seed=seed + b, base_config=base_config,
                              configs=cohort, mesh=mesh, verbose=verbose,
                              device=device)
        for tr in out["trials"]:
            sampler.tell(tr["config"], tr["best_val"])
        total_epochs += out["total_epochs"]
        history.append({"bracket": b, "trials": out["trials"],
                        "rungs": out["rungs"],
                        "best_value": out["best_value"]})
        if np.isfinite(out["best_value"]) and out["best_value"] < best["value"]:
            best = {"config": out["best_config"],
                    "value": out["best_value"],
                    "bundle": out["best_bundle"]}
        if verbose:
            print(f"[bohb] bracket {b}: best={out['best_value']:.5f} "
                  f"(incumbent {best['value']:.5f}), "
                  f"epochs so far {total_epochs}")
    if best["bundle"] is None:
        raise RuntimeError(
            "bohb_vae_search: no bracket produced a finite validation "
            "loss — widen/lower the lr range or check loss_type vs the "
            "data scale")
    return {"best_config": best["config"], "best_value": best["value"],
            "best_bundle": best["bundle"], "history": history,
            "total_epochs": total_epochs}
