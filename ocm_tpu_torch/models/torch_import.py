"""Import reference torch checkpoints into bundles (port of
``ocm_tpu/models/torch_import.py``).

The reference deploys one-class models as torch ``state_dict`` files whose
registered buffers carry the decision state: ``spec_mean``/``spec_std``,
``latent_mean``/``latent_cov_inv`` and the thresholds ``threshold``,
``threshold_q``, ``threshold_h`` and ``threshold_f``.  This module turns
such a checkpoint into an ``OCMBundle`` so that a trained reference model
is served here without retraining:

    bundle = load_torch_checkpoint("VAE_class0_best.pth", model)
    accept = vae_decision.decide_d2(model, bundle, x)

The port's ``ConvVAE1D`` has the reference module's state-dict keys
(``encoder_conv.N``, ``fc.0``, ``fc_mu``, ``fc_logvar``, ``fc_dec.N``,
``decoder_conv.N``) and torch's own layouts, so the weights load as they
are: none of the JAX package's kernel transposes, transposed-convolution
flips or flatten-order permutations applies.  The checkpoint is checked
against ``model`` key by key and shape by shape (``load_state_dict(...,
strict=True)`` on a copy).  Missing thresholds default to 0 (the
reference's initial buffer values), a missing ``latent_mean`` and
``latent_cov_inv`` to zeros and the identity, and ``q_threshold`` is read
as an alias of ``threshold_q``, as the JAX package does.
"""

from __future__ import annotations

import copy
from typing import Mapping

import torch

from ocm_tpu_torch._device import as_tensor, resolve_device
from ocm_tpu_torch.models.bundle import OCMBundle
from ocm_tpu_torch.models.vae import ConvVAE1D

# the decision buffers, in the order the reference's checkpoints list them
BUFFERS = ("threshold", "threshold_q", "threshold_h", "threshold_f",
           "spec_mean", "spec_std", "latent_mean", "latent_cov_inv")


def bundle_from_torch_state_dict(state: Mapping, model: ConvVAE1D,
                                 device=None) -> OCMBundle:
    """A reference ``ConvVAE1D.state_dict()`` (tensors or numpy arrays) as a
    bundle for ``model`` (built with the same hyperparameters) on
    ``device`` (CUDA unless given; float64 becomes float32 there)."""
    device = resolve_device(device)
    state = {k: as_tensor(v, device) for k, v in state.items()}
    weights = {k: v for k, v in state.items() if k not in BUFFERS
               and k != "q_threshold"}
    for key, ref in model.state_dict().items():
        if key.endswith("num_batches_tracked") and key not in weights:
            weights[key] = torch.zeros((), dtype=ref.dtype, device=device)
    # the key-by-key and shape-by-shape check, on a copy
    copy.deepcopy(model).load_state_dict(weights, strict=True)

    spec_mean = state["spec_mean"]
    dt = spec_mean.dtype
    k = model.latent_dim

    def buf(name, default):
        return state[name].to(dt) if name in state else default

    zero = torch.zeros((), dtype=dt, device=device)
    return OCMBundle(
        state_dict=weights, spec_mean=spec_mean,
        spec_std=state["spec_std"].to(dt),
        latent_mean=buf("latent_mean", torch.zeros(k, dtype=dt,
                                                   device=device)),
        latent_cov_inv=buf("latent_cov_inv", torch.eye(k, dtype=dt,
                                                       device=device)),
        threshold=buf("threshold", zero),
        threshold_q=buf("threshold_q", buf("q_threshold", zero.clone())),
        threshold_h=buf("threshold_h", zero.clone()),
        threshold_f=buf("threshold_f", zero.clone()))


def load_torch_checkpoint(path: str, model: ConvVAE1D,
                          device=None) -> OCMBundle:
    """Load a reference ``.pth`` checkpoint file (tensors only,
    ``weights_only=True``) as a bundle on ``device``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return bundle_from_torch_state_dict(state, model, device)
