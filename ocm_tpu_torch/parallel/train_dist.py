"""Data-parallel VAE training over a rank mesh (port of
``ocm_tpu/parallel/train_dist.py``).

The global minibatch shards over the mesh's ``'data'`` axis: each rank runs
the forward and backward on its rows, the gradients (with the loss and the
row count) all-reduce in one round, and every rank applies the same Adam
update to its replica.  BatchNorm averages its training statistics over
the ranks (``ConvVAE1D(bn_axis_name=axis)``, ``ops.bn.cross_replica_bn_act``,
the plain twin as in the reference: kernels K2/K3 stay on the
single-process path), so a step equals the single-process step on the
global batch, up to summation order.  The reparameterization runs K4 (and
K6's backward) on each rank's rows.

Randomness: each epoch's permutation comes from the replicated
``trainer.epoch_generator(seed, epoch)`` on the CPU, so every rank cuts
the same global batches; each rank draws its noise from its own generator
seeded (seed, epoch, axis index) and its dropout masks from (seed, epoch,
axis index + 65536): the counterparts of ``fold_in(rng, axis_index)`` and
``+ 65536``.  The steps also take the noise as an argument.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ocm_tpu_torch.models.bundle import new_bundle, spectral_stats
from ocm_tpu_torch.models.trainer import (TrainConfig, _clone_state,
                                          _dtype_of, epoch_generator,
                                          step_loss)
from ocm_tpu_torch.models.vae import BatchNormAct, ConvVAE1D
from ocm_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, pad_to_multiple,
                                         require_mesh_axis, shard_batch)


@contextlib.contextmanager
def _batchnorm_bound(model: ConvVAE1D, mesh: Mesh, axis: str):
    """Average ``model``'s BatchNorm statistics over ``mesh[axis]`` for the
    duration of the block; the layers hold no reference to the mesh after
    it, so the model stays picklable and trains nowhere else."""
    size = mesh.shape[axis]

    def pmean(t):
        return mesh.psum(t, axis, "bn stats") / size

    layers = [m for m in model.modules() if isinstance(m, BatchNormAct)]
    for mod in layers:
        mod.pmean = pmean
    try:
        yield
    finally:
        for mod in layers:
            mod.pmean = None


def make_dp_train_step(model: ConvVAE1D, opt, cfg: TrainConfig, mesh: Mesh,
                       axis: str = DATA_AXIS, spec=None):
    """step(xb_std, eps) -> loss: one data-parallel Adam step.

    ``xb_std`` is this rank's rows of the standardized global batch and
    ``eps`` their noise; ``opt`` is the replica's optimizer (every rank
    holds the same parameters and applies the same update).  The gradients
    are weighted by ``n_local / n_global`` and summed with the loss and the
    count in one all-reduce; the returned loss is the global batch's.
    ``model`` must be built with ``bn_axis_name=axis`` when it has
    BatchNorm.
    """
    require_mesh_axis(mesh, axis)
    if model.use_batchnorm and model.bn_axis_name != axis:
        raise ValueError(
            f"data-parallel training over axis {axis!r} needs "
            f"ConvVAE1D(bn_axis_name={axis!r}) (got "
            f"{model.bn_axis_name!r}): BatchNorm statistics must be "
            "averaged over the ranks")
    params = list(model.parameters())

    def step(xb_std, eps):
        model.train()
        with _batchnorm_bound(model, mesh, axis):
            total = step_loss(model, cfg, xb_std, eps, spec)
            opt.zero_grad(set_to_none=True)
            total.backward()
        n_local = float(xb_std.shape[0])
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        flat = mesh.psum(torch.cat([g.reshape(-1) for g in grads] + [
            total.detach().reshape(1), total.new_ones(1)]) * n_local, axis,
            "grads+loss+count")
        flat = flat[:-1] / flat[-1]
        for p, g in zip(params, flat[:-1].split([p.numel() for p in params])):
            p.grad = g.view_as(p)
        opt.step()
        return flat[-1]

    return step


def make_dp_eval_loss(model: ConvVAE1D, cfg: TrainConfig, mesh: Mesh,
                      axis: str = DATA_AXIS, spec=None):
    """eval_loss(x_std, eps) -> the global loss of a sharded set (this rank's
    rows and their noise): eval-mode BatchNorm, z still drawn through K4,
    the rank losses weighted by their row counts in one all-reduce."""
    require_mesh_axis(mesh, axis)

    def eval_loss(x_std, eps):
        model.eval()
        with torch.no_grad():
            total = step_loss(model, cfg, x_std, eps, spec)
            n_local = float(x_std.shape[0])
            s = mesh.psum(torch.stack([total, total.new_ones(())]) * n_local,
                          axis, "loss+count")
        return s[0] / s[1]

    return eval_loss


def _rank_generator(seed: int, epoch: int, index: int, device):
    state = np.random.SeedSequence([seed, epoch, index]).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def train_vae_dp(model: ConvVAE1D, x_cal, x_val, cfg: TrainConfig,
                 seed: int, mesh: Mesh, axis: str = DATA_AXIS,
                 spec_stats=None):
    """Full data-parallel training run (the sharded twin of
    ``models.trainer.train_vae``), on ``mesh.device``.

    Batches are global: each step takes ``cfg.batch_size`` spectra of the
    epoch's permutation (the remainder of an epoch is dropped, as in the
    reference), split evenly over the axis (``cfg.batch_size`` must divide
    by its size), and each rank moves its rows to its device.  The
    validation set pads to the axis size with repeated last rows.  The
    model trains in place from its own weights (``bn_axis_name=axis``).
    Returns ``(bundle, train_losses, val_losses, best_epoch)``, the same
    on every rank.
    """
    require_mesh_axis(mesh, axis)
    n_shards = mesh.shape[axis]
    if cfg.batch_size % n_shards:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"mesh axis size {n_shards}")
    device = mesh.device
    dtype = _dtype_of(x_cal, device, "train_vae_dp")
    x_cal = np.asarray(x_cal)
    mean, std = spectral_stats(x_cal) if spec_stats is None else spec_stats
    mean, std = np.asarray(mean), np.asarray(std)
    xc_std = (x_cal - mean) / std
    xv_std, _ = pad_to_multiple((np.asarray(x_val) - mean) / std, n_shards)
    xv_loc = shard_batch(xv_std, mesh, axis, "x_val").to(dtype)
    mean_t = torch.as_tensor(mean, dtype=dtype, device=device)
    std_t = torch.as_tensor(std, dtype=dtype, device=device)

    model.to(device=device, dtype=dtype)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                           weight_decay=cfg.weight_decay)
    spec = (mean_t, std_t) if cfg.loss_space == "raw" else None
    step = make_dp_train_step(model, opt, cfg, mesh, axis, spec)
    eval_loss = make_dp_eval_loss(model, cfg, mesh, axis, spec)

    n, k = xc_std.shape[0], model.latent_dim
    bs = max(min(cfg.batch_size, (n // n_shards) * n_shards), n_shards)
    steps = max(n // bs, 1)
    mine = mesh.rows(bs, axis)
    index = mesh.axis_index(axis)
    best_val, best_epoch, best_state = float("inf"), 0, _clone_state(model)
    train_losses, val_losses = [], []
    for epoch in range(cfg.epochs):
        perm = torch.randperm(n, generator=epoch_generator(seed, epoch,
                                                           "cpu")).numpy()
        gen = _rank_generator(seed, epoch, index, device)
        model.dropout_generator = _rank_generator(seed, epoch,
                                                  index + 65536, device)
        losses = []
        for si in range(steps):
            rows = perm[si * bs:(si + 1) * bs][mine]
            xb = torch.as_tensor(xc_std[rows], dtype=dtype, device=device)
            losses.append(step(xb, torch.randn(
                (xb.shape[0], k), generator=gen, device=device,
                dtype=dtype)))
        train_losses.append(float(torch.stack(losses).mean()))
        val = float(eval_loss(xv_loc, torch.randn(
            (xv_loc.shape[0], k), generator=gen, device=device,
            dtype=dtype)))
        val_losses.append(val)
        if val < best_val:
            best_val, best_epoch, best_state = val, epoch, _clone_state(model)
    model.dropout_generator = None
    model.train()
    bundle = new_bundle(best_state, mean_t, std_t, k)
    return bundle, np.asarray(train_losses), np.asarray(val_losses), \
        best_epoch
