"""OCMBundle: one deployable one-class VAE model.

Port of ``ocm_tpu/models/bundle.py``: the network's state dict plus the
decision state the reference registers as buffers on its torch module:
per-wavelength standardization (``spec_mean``/``spec_std``), the latent
mean and inverse covariance, and the D^2/Q/h/f thresholds.  The functions
take the architecture (a ``ConvVAE1D``) and a bundle and run
``bind(model, bundle)``, an eval-mode copy holding the bundle's weights on
its device, under ``torch.inference_mode()``: the caller's module is left
as it is, and a module that is already bound is used without a reload.

``save_bundle``/``load_bundle`` write and read the JAX package's msgpack
file of a bundle (``utils.msgpack_io``), so a model crosses either way.
``stack_bundles`` stacks N bundles (or N fitted ``VAESIMCAModel``s) along
a new leading class axis, the multi-class serving input, and
``class_slice`` takes one class back out.
"""

from __future__ import annotations

import copy
import functools
from typing import NamedTuple

import numpy as np
import torch

from ocm_tpu_torch._device import resolve_device
from ocm_tpu_torch.models.vae import (ConvVAE1D, vae_state_dict_from_numpy,
                                      vae_state_dict_to_numpy)
from ocm_tpu_torch.utils import msgpack_io


class OCMBundle(NamedTuple):
    """Network state dict + preprocessing + decision state."""

    state_dict: dict
    spec_mean: torch.Tensor       # (L,) per-wavelength mean
    spec_std: torch.Tensor        # (L,) per-wavelength std
    latent_mean: torch.Tensor     # (k,)
    latent_cov_inv: torch.Tensor  # (k, k)
    threshold: torch.Tensor       # D^2 threshold (scalar)
    threshold_q: torch.Tensor     # Q threshold
    threshold_h: torch.Tensor     # h threshold
    threshold_f: torch.Tensor     # f threshold


def new_bundle(state_dict, spec_mean, spec_std, latent_dim: int) -> OCMBundle:
    """Fresh bundle with identity latent stats and zero thresholds."""
    mean = torch.as_tensor(spec_mean)
    std = torch.as_tensor(spec_std, dtype=mean.dtype, device=mean.device)
    zero = torch.zeros((), dtype=mean.dtype, device=mean.device)
    return OCMBundle(
        state_dict=state_dict, spec_mean=mean, spec_std=std,
        latent_mean=torch.zeros(latent_dim, dtype=mean.dtype,
                                device=mean.device),
        latent_cov_inv=torch.eye(latent_dim, dtype=mean.dtype,
                                 device=mean.device),
        threshold=zero, threshold_q=zero.clone(), threshold_h=zero.clone(),
        threshold_f=zero.clone())


def _on_bundle(bundle: OCMBundle, x):
    return torch.as_tensor(x, dtype=bundle.spec_mean.dtype,
                           device=bundle.spec_mean.device)


def standardize(bundle: OCMBundle, x):
    """(x - spec_mean) / spec_std."""
    return (_on_bundle(bundle, x) - bundle.spec_mean) / bundle.spec_std


def unstandardize(bundle: OCMBundle, x_std):
    """x_std * spec_std + spec_mean."""
    return _on_bundle(bundle, x_std) * bundle.spec_std + bundle.spec_mean


def bind(model: ConvVAE1D, bundle: OCMBundle) -> ConvVAE1D:
    """A resident eval-mode copy of ``model`` holding ``bundle``'s weights
    on the bundle's device and dtype, with no parameter requiring grad.
    The bundle functions use it as it is, without reloading the state dict;
    given a module already bound to this bundle, returns it unchanged."""
    if getattr(model, "bound_state", None) is bundle.state_dict:
        return model
    bound = copy.deepcopy(model).to(device=bundle.spec_mean.device,
                                    dtype=bundle.spec_mean.dtype)
    bound.load_state_dict(bundle.state_dict)
    bound.eval().requires_grad_(False)
    bound.bound_state = bundle.state_dict
    return bound


def inference_entry(fn):
    """Decorate a decision entry point ``fn(model, bundle, ...)``: it runs
    on ``bind(model, bundle)`` under ``torch.inference_mode()``, so no
    autograd graph is kept and a resident module is never reloaded.  The
    binding happens outside inference mode: the copy's parameters stay
    ordinary tensors."""

    @functools.wraps(fn)
    def entry(model, bundle, *args, **kwargs):
        model = bind(model, bundle)
        with torch.inference_mode():
            return fn(model, bundle, *args, **kwargs)

    return entry


@inference_entry
def encode(model: ConvVAE1D, bundle: OCMBundle, x):
    """Raw spectra -> (mu, logvar), eval mode (standardization included)."""
    return model.encode(standardize(bundle, x))


@inference_entry
def decode(model: ConvVAE1D, bundle: OCMBundle, z):
    """Latent -> raw spectra, eval mode (unstandardization included)."""
    return unstandardize(bundle, model.decode(_on_bundle(bundle, z)))


def draw_seed(rng: torch.Generator) -> int:
    """An unsigned 64-bit kernel seed drawn from the CPU generator ``rng``
    on the host, so the card never waits for it."""
    lo, hi = torch.randint(0, 2 ** 32, (2,), generator=rng).tolist()
    return lo | hi << 32


@inference_entry
def forward(model: ConvVAE1D, bundle: OCMBundle, x, rng=None, eps=None):
    """Full VAE forward on raw spectra: (x_rec raw, mu, logvar), with z
    sampled as the reference's eval forward does.  Pass exactly one of
    ``rng``, a CPU ``torch.Generator`` from which one kernel seed is drawn
    (the noise then comes from kernel K5), or ``eps``, the noise itself."""
    if (rng is None) == (eps is None):
        raise ValueError("pass exactly one of rng (a CPU torch.Generator) "
                         "or eps (the noise)")
    noise = dict(seed=draw_seed(rng)) if eps is None \
        else dict(eps=_on_bundle(bundle, eps))
    x_rec_std, mu, logvar = model(standardize(bundle, x), **noise)
    return unstandardize(bundle, x_rec_std), mu, logvar


@inference_entry
def reconstruct(model: ConvVAE1D, bundle: OCMBundle, x):
    """Deterministic reconstruction through mu: (x_rec raw, mu)."""
    mu, _ = encode(model, bundle, x)
    return decode(model, bundle, mu), mu


def spectral_stats(x_train):
    """Per-wavelength mean/std of the calibration set with the reference's
    additive 1e-12 guard (numpy in, numpy out; tensors stay tensors)."""
    if isinstance(x_train, torch.Tensor):
        return x_train.mean(0), x_train.std(0, correction=0) + 1e-12
    x = np.asarray(x_train)
    return x.mean(axis=0), x.std(axis=0) + 1e-12


def ocm_bundle_from_numpy(tree, model: ConvVAE1D, device=None) -> OCMBundle:
    """A bundle of ``ocm_tpu`` as numpy (its fields as a mapping, or the
    bundle itself: flax ``params``/``batch_stats`` trees plus the decision
    arrays) as this package's bundle on ``device`` (CUDA unless given)."""
    tree = tree._asdict() if hasattr(tree, "_asdict") else dict(tree)
    device = resolve_device(device)
    state = vae_state_dict_from_numpy(tree["params"], tree["batch_stats"],
                                      model)
    rest = {f: torch.as_tensor(np.array(tree[f]), device=device)
            for f in OCMBundle._fields if f != "state_dict"}
    return OCMBundle(state_dict={k: v.to(device) for k, v in state.items()},
                     **rest)


def save_bundle(path, bundle: OCMBundle, model: ConvVAE1D) -> None:
    """Write ``bundle`` (of the architecture ``model``) as the JAX
    package's ``save_bundle`` does: one msgpack file of its flax
    ``params``/``batch_stats`` trees (``vae_state_dict_to_numpy``) and
    the decision arrays, in its field order.  The format holds no
    BatchNorm step counter: ``num_batches_tracked``, which the eval forward
    does not read, loads as 0."""
    params, batch_stats = vae_state_dict_to_numpy(bundle.state_dict, model)
    rest = {f: getattr(bundle, f).detach().cpu().numpy()
            for f in OCMBundle._fields if f != "state_dict"}
    msgpack_io.save(path, {"params": params, "batch_stats": batch_stats,
                           **rest}, sort_keys=False)


def load_bundle(path, model: ConvVAE1D, device=None) -> OCMBundle:
    """A bundle written by either package's ``save_bundle``, for the
    architecture ``model`` (which takes the place of the JAX package's
    template), on ``device`` (CUDA unless given)."""
    return ocm_bundle_from_numpy(msgpack_io.load(path), model, device)


def _paths(tree, path=""):
    """The leaf paths of a bundle-like tree (NamedTuples and dicts)."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{path}['{k}']")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for f in tree._fields
                for p in _paths(getattr(tree, f), f"{path}.{f}")]
    return [path]


def _map(fn, trees, path=""):
    """``fn(path, leaves)`` over the matching leaves of ``trees``, rebuilt
    in the first tree's structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, [t[k] for t in trees], f"{path}['{k}']")
                for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(_map(fn, [getattr(t, f) for t in trees],
                               f"{path}.{f}") for f in t0._fields))
    return fn(path, trees)


def stack_bundles(items):
    """Stack matching bundles (``OCMBundle``s of one architecture, or their
    fitted ``vaesimca.VAESIMCAModel``s) along a new leading class axis:
    every tensor of the state dict, the spectral and latent statistics and
    the thresholds.  A different structure, or a leaf whose shape differs,
    raises, naming the leaf."""
    if not items:
        raise ValueError("stack_bundles needs at least one pytree")
    paths0 = _paths(items[0])
    for i, b in enumerate(items[1:], 1):
        if type(b) is not type(items[0]) or _paths(b) != paths0:
            raise ValueError(
                f"stack_bundles: pytree {i} has a different structure "
                "than pytree 0 (mixed architectures?)")

    def stack(path, leaves):
        leaves = [torch.as_tensor(a) for a in leaves]
        shapes = {tuple(a.shape) for a in leaves}
        if len(shapes) != 1:
            raise ValueError(
                f"stack_bundles: leaf {path} shapes differ across classes: "
                f"{sorted(shapes)} — all classes must share one "
                "architecture/latent size")
        return torch.stack(leaves)

    return _map(stack, list(items))


def class_slice(stacked, c: int):
    """Class ``c`` of a stacked bundle or ``VAESIMCAModel``."""
    return _map(lambda _, leaves: leaves[0][c], [stacked])
