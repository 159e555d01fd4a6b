"""Config- and class-sharded sweeps: the stacked config-batch trainers of
``utils.sweep`` with their CONFIG (or CLASS) axis placed on the rank mesh
(port of ``ocm_tpu/parallel/sweep_dist.py``).

The config count pads cyclically to a multiple of the ``'model'`` axis
size (``parallel.mesh.cyclic_pad_to``); each rank trains its slice as one
``models.stacked.StackedVAE`` (``utils.sweep``'s own stacked run: one
K2/K3 launch a BatchNorm layer and one K4/K6 launch a step for all of the
rank's configs) with no collective in the epoch loop, and the results
gather into one ``TrainResult`` on every rank with the padded configs
dropped.  ``models.stacked`` keeps each config's layers its own, so a
config's run does not depend on which configs share its rank: a sharded
run equals the local stacked run of the same configs as tightly as the
stacked run equals the sequential one (bit for bit on the CPU).  Fresh
runs only: resume stays on the single-process trainers.
"""

from __future__ import annotations

import numpy as np

from ocm_tpu_torch.models.trainer import TrainConfig, TrainResult, _dtype_of
from ocm_tpu_torch.models.vae import ConvVAE1D
from ocm_tpu_torch.parallel.mesh import (MODEL_AXIS, Mesh, cyclic_pad_to,
                                         require_mesh_axis)
from ocm_tpu_torch.utils import sweep as _sweep

__all__ = ["train_vae_vmapped_sharded", "train_vae_classes_sharded"]


def _my_units(n: int, mesh: Mesh, axis: str) -> np.ndarray:
    """This rank's units of ``n`` padded cyclically to the axis size."""
    size = mesh.shape[axis]
    padded = cyclic_pad_to(np.arange(n), n + (-n) % size)
    return padded[mesh.rows(padded.shape[0], axis)]


def _gathered(out, mesh: Mesh, axis: str, n: int):
    """``_stacked_run``'s output gathered over ``axis``, padding dropped."""
    tl, vl, best_epoch, best_state, final_state, opt_state = \
        mesh.all_gather_tree(out, axis, "train result")
    cut = {k: v[:n] for k, v in best_state.items()}
    return (tl[:n], vl[:n], best_epoch[:n], cut,
            {k: v[:n] for k, v in final_state.items()},
            {"step": opt_state["step"],
             **{key: {k: v[:n] for k, v in opt_state[key].items()}
                for key in ("exp_avg", "exp_avg_sq")}})


def train_vae_vmapped_sharded(model: ConvVAE1D, x_cal, x_val, lrs,
                              weight_decays, betas, mesh: Mesh, *,
                              epochs: int, batch_size: int, loss_type: str,
                              seed: int = 0, cfg_seeds=None, spec_stats=None,
                              loss_space: str = "std", val_every: int = 1,
                              model_axis: str = MODEL_AXIS) -> TrainResult:
    """``utils.sweep.train_vae_vmapped`` with the config axis sharded over
    ``mesh[model_axis]``, on ``mesh.device``.

    Same contract: config c runs ``train_vae(seeded_vae(model, s_c), ...,
    seed=s_c)`` with ``s_c = cfg_seeds[c]`` (default ``config_seed(seed,
    c)``), and the ``TrainResult`` (on every rank) carries a leading config
    axis of length ``len(lrs)``.
    """
    require_mesh_axis(mesh, model_axis)
    (lrs, weight_decays, betas, cfg_seeds, xc_std, xv_std, mean, std,
     cfg) = _sweep.sweep_prep(x_cal, x_val, lrs, weight_decays, betas,
                              epochs, batch_size, loss_type, loss_space,
                              val_every, spec_stats, seed, cfg_seeds,
                              mesh.device)
    n_cfg = len(lrs)
    mine = _my_units(n_cfg, mesh, model_axis)
    spec = [(mean, std)] * len(mine) if loss_space == "raw" else None
    out = _sweep._stacked_run(
        model, cfg, [lrs[c] for c in mine], [weight_decays[c] for c in mine],
        [betas[c] for c in mine], [cfg_seeds[c] for c in mine],
        xc_std[:len(mine)], xv_std[:len(mine)], spec, None, 0)
    return _sweep.sweep_result(_gathered(out, mesh, model_axis, n_cfg), mean,
                               std, model, epoch_offset=0)


def train_vae_classes_sharded(model: ConvVAE1D, x_cals, x_vals,
                              cfg: TrainConfig, mesh: Mesh, seed: int = 0,
                              spec_stats=None,
                              model_axis: str = MODEL_AXIS) -> TrainResult:
    """``utils.sweep.train_vae_classes`` with the CLASS axis on the mesh:
    each rank trains its slice of the per-class one-class VAEs, with the
    local trainer's per-class standardization, seeds and cyclic padding of
    unequal class sizes (to the largest class of all), on ``mesh.device``.
    The ``TrainResult`` (on every rank) is stacked as
    ``models.bundle.stack_bundles`` stacks, ready for the multi-class
    ``serving.VAEScorer`` after per-class ``fit_thresholds``.
    """
    require_mesh_axis(mesh, model_axis)
    xcs, xvs, means, stds, n_max = _sweep.classes_prep(x_cals, x_vals,
                                                       spec_stats)
    dtype = _dtype_of(x_cals[0], mesh.device, "train_vae_classes_sharded")
    n_cls = xcs.shape[0]
    means_t, stds_t, out = _sweep.classes_run(
        model, cfg, seed, xcs, xvs, means, stds, n_max,
        _my_units(n_cls, mesh, model_axis), mesh.device, dtype)
    return _sweep.classes_result(_gathered(out, mesh, model_axis, n_cls),
                                 means_t, stds_t, model)
