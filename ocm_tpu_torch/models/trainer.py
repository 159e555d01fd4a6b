"""One-class VAE training: Adam, validation and best-checkpoint selection.

Port of ``ocm_tpu/models/trainer.py``.  JAX runs the whole multi-epoch loop
as one compiled program; here it is a Python loop over epochs and steps on
the card, with the calibration and validation sets resident there.  Each
train step launches kernels K2 and K3 once per BatchNorm layer and K4 once;
each validation pass launches K4 once (eval-mode BatchNorm is plain
elementwise torch).

- Optimizer: ``torch.optim.Adam(lr, weight_decay)``, the rule JAX's
  ``torch_adam`` reproduces (L2 added to the gradient before the moments).
- Batching: ceil(N / B) steps an epoch, the epoch's permutation wrapped to
  fill the last batch.
- Randomness: each epoch draws from its own ``torch.Generator`` on the
  training device, seeded from ``(seed, global epoch)``: first the
  permutation, then each step's noise (and dropout masks), then the
  validation noise.  A resumed run (``init_state``, ``epoch_offset``)
  continues the same streams.  JAX's random bits cannot be replayed, so
  parity with ``ocm_tpu`` is checked with the noise passed in.
- Best checkpoint: strict ``<`` against an initial ``inf``, so a NaN or a
  skipped (``inf``) validation never wins; a device-side copy of the
  state dict.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ocm_tpu_torch._device import resolve_device
from ocm_tpu_torch.models.bundle import OCMBundle, new_bundle, spectral_stats
from ocm_tpu_torch.models.vae import ConvVAE1D, recon_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters of one VAE training run (as ``ocm_tpu``'s)."""

    epochs: int = 100
    batch_size: int = 64
    lr: float = 1e-3
    weight_decay: float = 0.0
    beta: float = 1.0
    loss_type: str = "cosine"   # cosine | bce | euclidean | bce_prob
    # validate every k-th epoch (global count); skipped epochs report inf
    val_every: int = 1
    # 'std': losses on standardized spectra; 'raw': reconstruction mapped
    # back to raw spectral space first (the reference's exact objective)
    loss_space: str = "std"


class TrainResult(NamedTuple):
    bundle: OCMBundle            # best-validation-epoch state (thresholds unset)
    train_losses: np.ndarray     # (epochs,)
    val_losses: np.ndarray       # (epochs,)
    best_epoch: int
    final_state: dict            # last-epoch model state dict (for resume)
    final_opt_state: dict        # last-epoch Adam state dict


def _clone_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of global epoch ``epoch`` of a run seeded ``seed``."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def batch_indices(generator, n: int, batch_size: int, device):
    """Shuffled epoch indices, wrapped to fill ceil(n / B) full batches."""
    steps = -(-n // batch_size)
    perm = torch.randperm(n, generator=generator, device=device)
    pad = steps * batch_size - n
    if pad:
        perm = torch.cat([perm, perm[:pad]])
    return perm.view(steps, batch_size)


def _loss_pair(cfg: TrainConfig, xb_std, x_rec_std, spec):
    """(target, reconstruction) in the configured loss space."""
    if cfg.loss_space == "raw" and spec is not None:
        mean, std = spec
        return xb_std * std + mean, x_rec_std * std + mean
    return xb_std, x_rec_std


def step_loss(model: ConvVAE1D, cfg: TrainConfig, xb_std, eps, spec=None):
    """The loss of one minibatch in the model's current mode: encode,
    reparameterize (K4; its per-sample KL is the KL term), decode, and
    recon + beta * mean KL in the configured loss space."""
    mu, logvar = model.encode(xb_std)
    z, kl = model.reparameterize(mu, logvar, eps)
    x_rec = model.decode(z)
    x_cmp, r_cmp = _loss_pair(cfg, xb_std, x_rec, spec)
    return recon_loss(x_cmp, r_cmp, cfg.loss_type) + cfg.beta * kl.mean()


def make_train_step(model: ConvVAE1D, opt, cfg: TrainConfig, spec=None):
    """step(xb_std, eps) -> loss: one Adam step on a standardized
    minibatch with the noise ``eps`` (B, latent_dim).  The BatchNorm running
    statistics update in the training forward."""

    def step(xb_std, eps):
        model.train()
        total = step_loss(model, cfg, xb_std, eps, spec)
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        return total.detach()

    return step


def make_eval_loss(model: ConvVAE1D, cfg: TrainConfig, spec=None):
    """eval_loss(x_std, eps) -> loss over a whole standardized set: eval-mode
    BatchNorm, z still drawn (through K4) as the reference's eval forward
    does."""

    def eval_loss(x_std, eps):
        model.eval()
        with torch.no_grad():
            return step_loss(model, cfg, x_std, eps, spec)

    return eval_loss


def _dtype_of(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return torch.float64 if x.dtype == torch.float64 else torch.float32
    return torch.float64 if np.asarray(x).dtype == np.float64 \
        else torch.float32


def train_vae(model: ConvVAE1D, x_cal, x_val, cfg: TrainConfig, seed: int,
              spec_stats: Optional[tuple] = None,
              init_state: Optional[tuple] = None, epoch_offset: int = 0,
              device=None) -> TrainResult:
    """Train ``model`` in place and return the best-validation-epoch bundle.

    ``x_cal``/``x_val`` are raw spectra (numpy or tensors); standardization
    stats come from the calibration set unless passed.  The run goes to
    ``device``, else the device of a tensor ``x_cal``, else CUDA; it
    computes in float64 for float64 inputs, else float32.  It starts from
    the model's own weights, or from ``init_state = (state_dict,
    opt_state_dict or None)`` of an earlier result; ``epoch_offset`` is the
    number of epochs already run, for resuming the same random streams.
    """
    device = resolve_device(device, x_cal)
    dtype = _dtype_of(x_cal)
    mean, std = spectral_stats(x_cal) if spec_stats is None else spec_stats
    mean = torch.as_tensor(mean, dtype=dtype, device=device)
    std = torch.as_tensor(std, dtype=dtype, device=device)
    xc_std = (torch.as_tensor(x_cal, dtype=dtype, device=device) - mean) / std
    xv_std = (torch.as_tensor(x_val, dtype=dtype, device=device) - mean) / std

    model.to(device=device, dtype=dtype)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                           weight_decay=cfg.weight_decay)
    if init_state is not None:
        state, opt_state = init_state
        model.load_state_dict(state)
        if opt_state is not None:
            opt.load_state_dict(opt_state)
    spec = (mean, std) if cfg.loss_space == "raw" else None
    step = make_train_step(model, opt, cfg, spec)
    eval_loss = make_eval_loss(model, cfg, spec)

    n, k = xc_std.shape[0], model.latent_dim
    batch_size = min(cfg.batch_size, n)
    best_val, best_epoch, best_state = float("inf"), 0, _clone_state(model)
    train_losses, val_losses = [], []
    for e in range(cfg.epochs):
        epoch = epoch_offset + e
        gen = epoch_generator(seed, epoch, device)
        model.dropout_generator = gen
        idx = batch_indices(gen, n, batch_size, device)
        losses = [step(xc_std[rows], torch.randn(
            (batch_size, k), generator=gen, device=device, dtype=dtype))
            for rows in idx]
        train_losses.append(torch.stack(losses).mean())
        if (epoch + 1) % cfg.val_every == 0:
            val = float(eval_loss(xv_std, torch.randn(
                (xv_std.shape[0], k), generator=gen, device=device,
                dtype=dtype)))
        else:
            val = float("inf")
        val_losses.append(val)
        if val < best_val:
            best_val, best_epoch, best_state = val, e, _clone_state(model)
    model.dropout_generator = None
    model.train()

    bundle = new_bundle(best_state, mean, std, k)
    return TrainResult(
        bundle, torch.stack(train_losses).cpu().numpy() if train_losses
        else np.zeros(0), np.asarray(val_losses), best_epoch + epoch_offset,
        _clone_state(model), copy.deepcopy(opt.state_dict()))


def train_vae_blocked(model: ConvVAE1D, x_cal, x_val, cfg: TrainConfig,
                      seed: int, block_epochs: int = 10,
                      report: Optional[Callable] = None,
                      spec_stats: Optional[tuple] = None,
                      device=None) -> TrainResult:
    """Train in blocks of ``block_epochs`` with a host callback between them
    (the mid-training pruning hook).

    ``report(epoch, train_loss, val_loss) -> bool`` is called once per
    completed epoch; True stops training at the end of the block.  The
    trajectory is the monolithic ``train_vae``'s with the same seed: each
    block resumes from the last one's final state with ``epoch_offset``.
    The best checkpoint is the best REPORTED epoch (``nanargmin`` over the
    reported prefix of each block, strict ``<`` across blocks); where a
    prune cut a block before its own best, the reported prefix is re-run
    from the block's entry state to recover that checkpoint.
    """
    if spec_stats is None:
        spec_stats = spectral_stats(x_cal)
    state = (_clone_state(model), None)
    train_losses, val_losses = [], []
    best_val, best_bundle, best_epoch = np.inf, None, 0
    done, stopped = 0, False
    while done < cfg.epochs and not stopped:
        k = min(block_epochs, cfg.epochs - done)
        entry_state = state
        r = train_vae(model, x_cal, x_val, dataclasses.replace(cfg, epochs=k),
                      seed, spec_stats=spec_stats, init_state=state,
                      epoch_offset=done, device=device)
        state = (r.final_state, r.final_opt_state)
        seen = k
        for e in range(k):
            tl, vl = float(r.train_losses[e]), float(r.val_losses[e])
            train_losses.append(tl)
            val_losses.append(vl)
            if report is not None and report(done + e, tl, vl):
                stopped, seen = True, e + 1
                break
        vl = r.val_losses[:seen]
        if seen and np.isfinite(vl).any():
            prefix_best = int(np.nanargmin(vl))
            if float(vl[prefix_best]) < best_val:
                best_val = float(vl[prefix_best])
                best_epoch = done + prefix_best
                if r.best_epoch - done == prefix_best:
                    best_bundle = r.bundle
                else:
                    best_bundle = train_vae(
                        model, x_cal, x_val,
                        dataclasses.replace(cfg, epochs=prefix_best + 1),
                        seed, spec_stats=spec_stats, init_state=entry_state,
                        epoch_offset=done, device=device).bundle
                    # the re-run left the model at the prefix's end
                    model.load_state_dict(state[0])
        done += k
    return TrainResult(best_bundle, np.asarray(train_losses),
                       np.asarray(val_losses), best_epoch, *state)
