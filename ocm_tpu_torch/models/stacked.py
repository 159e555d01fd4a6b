"""C ConvVAE1Ds of one architecture as one module: config- and class-stacked
training.

Port of the ``jax.vmap`` axis of ``ocm_tpu/utils/sweep.py``
(``vmapped_train_body`` :158-191, ``classes_train_body`` :296-317).  JAX
vmaps the training program over configs.  Here a train step of all C
configs is one forward and one backward of one module whose parameters
carry a leading config axis (the state dict has the single model's keys,
each tensor (C, ...): ``models.bundle.stack_bundles``'s layout, so
``stack_vaes``/``unstack_state`` are a ``torch.stack`` and an index):

- the kernels are shared: training BatchNorm runs ``fused_bn_act`` once
  over the configs' activations side by side, (B, C*F, L), so ONE launch
  of K2 (forward) and of K3 (backward) a layer serves every config, each
  channel split over the single model's cluster size; the
  reparameterization runs ``fused_reparam_kl`` once over (C*B, k) rows,
  so ONE launch of K4 and of K6's backward a step serves every config;
- each config's convolutions, dense layers, activations and loss are the
  single model's own calls on its own slices (cuDNN and cuBLAS pick their
  algorithms by shape, so config c gets the same algorithms, and the same
  bits, as a lone ``ConvVAE1D``).  Grouped convolutions and batched
  products would batch these too, but they sum in another order, and
  Adam turns such last-bit differences into lr-sized steps wherever a
  gradient is pure rounding (the conv biases ahead of a BatchNorm), which
  eval-mode BatchNorm then sees: training runs that are unstable drift
  apart.  Kept per config, a config's run does not depend on the configs
  stacked beside it.

Dropout masks come from each config's own generator
(``dropout_generators``), drawn in the single model's layer order with its
shapes.  ``StackedAdam`` is ``torch.optim.Adam(lr_c, weight_decay=wd_c)``
for config c (JAX's ``traced_adam``, ``sweep.py:149-155``): torch's own
Adam once a config over its slices of the stacked tensors (plain torch, as
the JAX package computes Adam outside any Pallas kernel).  The carriers
(``stacked_state_dict_*``, ``stacked_adam_state_*``) move a vmapped JAX
run's parameter, BatchNorm and optax Adam trees, as numpy, into this
layout and back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.optim.adam import adam

from ocm_tpu_torch.models.trainer import TrainConfig, _loss_pair
from ocm_tpu_torch.models.vae import (ConvVAE1D, recon_loss,
                                      vae_state_dict_from_numpy,
                                      vae_state_dict_to_numpy)
from ocm_tpu_torch.ops.bn import (apply_act, bn_act_normalize, fused_bn_act,
                                  k2_cluster_size)
from ocm_tpu_torch.ops.kernels import fused_reparam_kl


def arch_kwargs(model: ConvVAE1D) -> dict:
    """The constructor arguments of ``model``'s architecture."""
    return dict(input_length=model.input_length, latent_dim=model.latent_dim,
                conv_blocks=model.conv_blocks, n_filters=model.n_filters,
                kernel_size=model.kernel_size, stride=model.stride,
                hidden_fc=model.hidden_fc, activation=model.activation,
                dropout=model.dropout, use_batchnorm=model.use_batchnorm,
                init_nonlinearity=model.init_nonlinearity)


def seeded_vae(model: ConvVAE1D, seed: int) -> ConvVAE1D:
    """A fresh ``ConvVAE1D`` of ``model``'s architecture whose initial
    weights come from a CPU generator seeded ``seed``: a config's (or
    trial's) initial weights in the sweeps."""
    return ConvVAE1D(**arch_kwargs(model),
                     generator=torch.Generator().manual_seed(int(seed)))


def config_seed(seed: int, i: int) -> int:
    """The seed of config (or trial, or class) ``i`` of a sweep seeded
    ``seed``: the 64-bit state of numpy's ``SeedSequence(seed)`` child
    ``i`` (its ``spawn_key (i,)``).  It stands where ``ocm_tpu`` takes
    ``jax.random.split(key, C)[i]`` (configs, classes) or
    ``jax.random.fold_in(key, i)`` (ASHA's and TPE's trials): one stream a
    config, fixed by (seed, i) alone, so a config keeps its stream when
    the population around it changes."""
    ss = np.random.SeedSequence(int(seed), spawn_key=(int(i),))
    return int(ss.generate_state(1, np.uint64)[0])


class _StackedRng:
    """The per-config generators dropout masks come from (None: torch's
    default generator of the tensor's device)."""

    generators = None


class StackedConv1d(nn.Module):
    """C ``Conv1d``s, weight (C, out, in, k) and bias (C, out): each
    config's (B, in, L) through its own slice."""

    def __init__(self, n, in_ch, out_ch, kernel_size, stride, padding):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(n, out_ch, in_ch, kernel_size))
        self.bias = nn.Parameter(torch.zeros(n, out_ch))

    def forward(self, hs):
        return [F.conv1d(h, w, b, self.stride, self.padding) for h, w, b in
                zip(hs, self.weight.unbind(0), self.bias.unbind(0))]


class StackedConvTranspose1d(nn.Module):
    """C ``ConvTranspose1d``s, weight (C, in, out, k) and bias (C, out)."""

    def __init__(self, n, in_ch, out_ch, kernel_size, stride, padding,
                 output_padding):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.weight = nn.Parameter(torch.zeros(n, in_ch, out_ch, kernel_size))
        self.bias = nn.Parameter(torch.zeros(n, out_ch))

    def forward(self, hs):
        return [F.conv_transpose1d(h, w, b, self.stride, self.padding,
                                   self.output_padding)
                for h, w, b in zip(hs, self.weight.unbind(0),
                                   self.bias.unbind(0))]


class StackedLinear(nn.Module):
    """C ``Linear``s, weight (C, out, in) and bias (C, out)."""

    def __init__(self, n, in_features, out_features):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(n, out_features))

    def forward(self, hs):
        return [F.linear(h, w, b) for h, w, b in
                zip(hs, self.weight.unbind(0), self.bias.unbind(0))]


class StackedAct(nn.Module):
    """The activation of each config's tensor."""

    def __init__(self, act: str):
        super().__init__()
        self.act = act

    def forward(self, hs):
        return [apply_act(h, self.act) for h in hs]


class StackedBatchNormAct(nn.Module):
    """C ``BatchNormAct``s.  Training: the configs' (B, F, L) side by side
    as (B, C*F, L) through one ``fused_bn_act`` (K2/K3), each channel over
    the single model's cluster size, and the stacked running update.
    Eval: each config's running statistics, elementwise."""

    def __init__(self, n, num_features, act="elu", momentum=0.9, eps=1e-5):
        super().__init__()
        self.act, self.momentum, self.eps = act, momentum, eps
        self.weight = nn.Parameter(torch.ones(n, num_features))
        self.bias = nn.Parameter(torch.zeros(n, num_features))
        self.register_buffer("running_mean", torch.zeros(n, num_features))
        self.register_buffer("running_var", torch.ones(n, num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros(n, dtype=torch.long))

    def forward(self, hs):
        if not self.training:
            return [bn_act_normalize(h, m, v, w, b, self.eps, self.act)
                    for h, m, v, w, b in zip(
                        hs, self.running_mean, self.running_var,
                        self.weight, self.bias)]
        nb, nf, nl = hs[0].shape
        out, mean, var = fused_bn_act(
            torch.cat(hs, 1), self.weight.reshape(-1), self.bias.reshape(-1),
            self.eps, self.act, k2_cluster_size(nb, nf, nl))
        m = self.momentum
        with torch.no_grad():
            shape = self.running_mean.shape
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean.view(shape))
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * var.view(shape))
            self.num_batches_tracked += 1
        return list(out.split(nf, 1))


class StackedDropout(nn.Module):
    """flax ``nn.Dropout`` per config: config c's mask drawn from its own
    generator with the single model's shape."""

    def __init__(self, p: float, rng: _StackedRng):
        super().__init__()
        self.p, self.rng = p, rng

    def forward(self, hs):
        if not self.training or self.p <= 0:
            return hs
        keep = 1.0 - self.p
        gens = self.rng.generators or [None] * len(hs)
        return [torch.where(torch.rand(h.shape, generator=g, device=h.device,
                                       dtype=h.dtype) < keep,
                            h / keep, torch.zeros_like(h))
                for h, g in zip(hs, gens)]


class StackedVAE(nn.Module):
    """``n`` ``ConvVAE1D``s of ``model``'s architecture as one module.

    ``encode`` takes standardized spectra (C, B, L) (or C tensors (B, L))
    and returns mu, logvar (C, B, k); ``reparameterize`` returns z
    (C, B, k) and the per-sample KL (C, B); ``decode`` takes z (C, B, k).
    The weights are zero until loaded (``load_state_dict(stack_vaes(
    models))``, or ``stacked_vae``).
    """

    def __init__(self, model: ConvVAE1D, n: int):
        super().__init__()
        self.n = int(n)
        self.input_length, self.latent_dim = model.input_length, model.latent_dim
        self.enc_shape = model.enc_shape
        self.activation, self.dropout = model.activation, model.dropout
        self.use_batchnorm = model.use_batchnorm
        self._rng = _StackedRng()
        k, pad, stride = model.kernel_size, model.kernel_size // 2, model.stride
        enc_ch, enc_len = self.enc_shape
        fc_in, hidden = enc_ch * enc_len, model.hidden_fc

        enc, in_ch, filters = [], 1, model.n_filters
        for b in range(model.conv_blocks):
            enc.append(StackedConv1d(n, in_ch, filters, k,
                                     1 if b == 0 else stride, pad))
            enc += self._bn_act_drop(filters)
            in_ch, filters = filters, min(filters * 2, 1024)
        self.encoder_conv = nn.Sequential(*enc)
        self.fc = nn.Sequential(StackedLinear(n, fc_in, hidden),
                                StackedAct(self.activation), self._drop())
        self.fc_mu = StackedLinear(n, hidden, self.latent_dim)
        self.fc_logvar = StackedLinear(n, hidden, self.latent_dim)
        self.fc_dec = nn.Sequential(
            StackedLinear(n, self.latent_dim, hidden),
            StackedAct(self.activation), self._drop(),
            StackedLinear(n, hidden, fc_in), StackedAct(self.activation))
        dec, filters = [], enc_ch
        for b in range(model.conv_blocks):
            nxt = max(filters // 2, model.n_filters)
            s = stride if b < model.conv_blocks - 1 else 1
            dec.append(StackedConvTranspose1d(n, filters, nxt, k, s, pad,
                                              s - 1))
            dec += self._bn_act_drop(nxt)
            filters = nxt
        dec.append(StackedConv1d(n, filters, 1, 1, 1, 0))
        self.decoder_conv = nn.Sequential(*dec)

    def _drop(self):
        return StackedDropout(self.dropout, self._rng) if self.dropout > 0 \
            else nn.Identity()

    def _bn_act_drop(self, channels):
        """``ConvVAE1D._bn_act_drop``, stacked: the same layer indices, so
        the state-dict keys are the single model's."""
        layers = ([StackedBatchNormAct(self.n, channels, self.activation),
                   nn.Identity()] if self.use_batchnorm
                  else [StackedAct(self.activation)])
        return layers + ([self._drop()] if self.dropout > 0 else [])

    @property
    def dropout_generators(self):
        return self._rng.generators

    @dropout_generators.setter
    def dropout_generators(self, generators):
        """The C generators dropout masks are drawn from, config c's from
        the c-th (None: torch's default generator)."""
        if generators is not None and len(generators) != self.n:
            raise ValueError(f"{len(generators)} generators for "
                             f"{self.n} configs")
        self._rng.generators = generators

    def encode(self, x):
        """Standardized spectra (C, B, L) -> (mu, logvar), each (C, B, k)."""
        hs = self.encoder_conv([xc.unsqueeze(1) for xc in x])
        hs = self.fc([h.flatten(1) for h in hs])
        return torch.stack(self.fc_mu(hs)), torch.stack(self.fc_logvar(hs))

    def reparameterize(self, mu, logvar, eps):
        """(z (C, B, k), kl (C, B)): one K4 launch over the C*B rows."""
        n, b, k = mu.shape
        z, kl = fused_reparam_kl(mu.reshape(n * b, k),
                                 logvar.reshape(n * b, k),
                                 eps.reshape(n * b, k))
        return z.view(n, b, k), kl.view(n, b)

    def decode_each(self, z) -> list:
        """Latent (C, B, k) -> each config's standardized spectra (B, L)."""
        hs = self.fc_dec(list(z.unbind(0)))
        hs = self.decoder_conv([h.view(h.shape[0], *self.enc_shape)
                                for h in hs])
        out = []
        for h in hs:
            x_rec = h.squeeze(1)
            out_len = x_rec.shape[-1]
            out.append(x_rec[..., :self.input_length]
                       if out_len > self.input_length
                       else F.pad(x_rec, (0, self.input_length - out_len)))
        return out

    def decode(self, z):
        """Latent (C, B, k) -> standardized spectra (C, B, L)."""
        return torch.stack(self.decode_each(z))


# ---------------------------------------------------------------------------
# stacking and the weight carriers
# ---------------------------------------------------------------------------


def stack_vaes(models) -> dict:
    """C ``ConvVAE1D`` (or their state dicts) of one architecture -> the
    stacked state dict: every tensor with a leading config axis."""
    states = [m.state_dict() if isinstance(m, nn.Module) else m
              for m in models]
    if not states:
        raise ValueError("stack_vaes needs at least one model")
    keys = list(states[0])
    for i, s in enumerate(states[1:], 1):
        if list(s) != keys:
            raise ValueError(f"stack_vaes: model {i} has other state-dict "
                             "keys than model 0 (mixed architectures?)")
    return {k: torch.stack([s[k] for s in states]) for k in keys}


def unstack_state(state: dict, c: int) -> dict:
    """Config ``c``'s state dict (views) of a stacked one."""
    return {k: v[c] for k, v in state.items()}


def stacked_vae(model: ConvVAE1D, states, device=None,
                dtype=None) -> StackedVAE:
    """A ``StackedVAE`` holding ``states`` (a stacked state dict, or a
    sequence of C models or state dicts) on ``device`` in ``dtype`` (by
    default the states' own)."""
    if not isinstance(states, dict):
        states = stack_vaes(states)
    first = next(v for v in states.values() if v.is_floating_point())
    # cast first, then load: loading into the default float32 first
    # would round a float64 state
    smodel = StackedVAE(model, first.shape[0]).to(
        device=device or first.device, dtype=dtype or first.dtype)
    smodel.load_state_dict(states)
    return smodel


def _tree_take(tree, c):
    """Leaf ``c`` of a nested dict of arrays with a leading axis."""
    if isinstance(tree, dict):
        return {k: _tree_take(v, c) for k, v in tree.items()}
    return np.asarray(tree)[c]


def _tree_stack(trees):
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def _leading(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(np.shape(tree)[0])


def stacked_state_dict_from_numpy(params, batch_stats,
                                  model: ConvVAE1D) -> dict:
    """A vmapped JAX ``ConvVAE1D``'s flax trees (``params``,
    ``batch_stats``; numpy leaves with a leading config axis) as the
    stacked state dict (CPU tensors), config by config through
    ``vae_state_dict_from_numpy``."""
    n = _leading(params)
    return stack_vaes([vae_state_dict_from_numpy(
        _tree_take(params, c), _tree_take(batch_stats or {}, c), model)
        for c in range(n)])


def stacked_state_dict_to_numpy(state: dict, model: ConvVAE1D):
    """The inverse of ``stacked_state_dict_from_numpy``: stacked flax trees
    ``(params, batch_stats)`` of numpy arrays."""
    n = next(iter(state.values())).shape[0]
    trees = [vae_state_dict_to_numpy(unstack_state(state, c), model)
             for c in range(n)]
    return (_tree_stack([t[0] for t in trees]),
            _tree_stack([t[1] for t in trees]) if trees[0][1] else {})


def _param_names(model: ConvVAE1D) -> list:
    return [name for name, _ in StackedVAE(model, 1).named_parameters()]


def stacked_adam_state_from_numpy(count, mu, nu, model: ConvVAE1D) -> dict:
    """optax Adam state of a vmapped JAX run (``traced_adam``'s or
    ``torch_adam``'s ``ScaleByAdamState``: ``count`` (C,), first and second
    moments ``mu``/``nu`` as flax parameter trees with a leading config
    axis, numpy) as a ``StackedAdam`` state dict.  The moments go through
    the parameters' layout transforms, which only permute entries, so
    they commute with Adam's elementwise update.  The configs of one
    stacked run step together: their counts must be equal."""
    counts = np.unique(np.asarray(count))
    if counts.size != 1:
        raise ValueError(f"the configs' Adam step counts differ: {counts}")

    def carry(tree):
        # the BatchNorm running statistics are not Adam state: stand-ins
        # for the carrier, dropped after it
        stats = {name: {"mean": v["scale"], "var": v["scale"]}
                 for name, v in tree.items() if "_bn" in name}
        state = stacked_state_dict_from_numpy(tree, stats, model)
        return {k: state[k] for k in _param_names(model)}

    return {"step": int(counts[0]), "exp_avg": carry(mu),
            "exp_avg_sq": carry(nu)}


def stacked_adam_state_to_numpy(opt_state: dict, model: ConvVAE1D):
    """The inverse of ``stacked_adam_state_from_numpy``: ``(count, mu,
    nu)`` with ``count`` (C,) int32 and the moments as stacked flax
    parameter trees."""
    def tree(moments):
        state = dict(moments)
        for name, v in StackedVAE(model, 1).named_buffers():
            if "running" in name:
                state[name] = torch.zeros(
                    next(iter(moments.values())).shape[:1]
                    + v.shape[1:], dtype=torch.float64)
        return stacked_state_dict_to_numpy(state, model)[0]

    mu = tree(opt_state["exp_avg"])
    return (np.full(_leading(mu), opt_state["step"], np.int32), mu,
            tree(opt_state["exp_avg_sq"]))


# ---------------------------------------------------------------------------
# the stacked optimizer and step
# ---------------------------------------------------------------------------


class StackedAdam:
    """``torch.optim.Adam(lr_c, weight_decay=wd_c)`` for each config c of a
    ``StackedVAE``: each step runs torch's own Adam (``torch.optim.adam.
    adam``, the function ``torch.optim.Adam.step`` calls, with its default
    foreach choice) once a config, over the config's slices of the stacked
    parameters, gradients and moments.  So config c's update is bit for
    bit the one a lone ``torch.optim.Adam`` makes from the same gradient,
    and a config's NaN stays in its own slices."""

    def __init__(self, model: StackedVAE, lrs, weight_decays,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = dict(model.named_parameters())
        self.lrs = [float(v) for v in lrs]
        self.weight_decays = [float(v) for v in weight_decays]
        if len(self.lrs) != model.n or len(self.weight_decays) != model.n:
            raise ValueError(f"{len(self.lrs)} lrs and "
                             f"{len(self.weight_decays)} weight decays for "
                             f"{model.n} configs")
        self.betas, self.eps = betas, eps
        self.exp_avg = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(p)
                           for k, p in self.params.items()}
        # torch.optim.Adam's per-parameter step counts (CPU scalars), and
        # each config's views of the parameters and moments
        self.steps = [[torch.tensor(0.0) for _ in self.params]
                      for _ in range(model.n)]
        with torch.no_grad():
            self._views = [tuple([a[c] for a in d.values()] for d in (
                self.params, self.exp_avg, self.exp_avg_sq))
                for c in range(model.n)]

    def zero_grad(self):
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params.values()]
        for c, (lr, wd) in enumerate(zip(self.lrs, self.weight_decays)):
            params, m, v = self._views[c]
            adam(params, [g[c] for g in grads], m, v, [], self.steps[c],
                 amsgrad=False, beta1=self.betas[0], beta2=self.betas[1],
                 lr=lr, weight_decay=wd, eps=self.eps, maximize=False)

    @property
    def step_count(self) -> int:
        return int(self.steps[0][0])

    def state_dict(self) -> dict:
        return {"step": self.step_count,
                "exp_avg": {k: v.clone() for k, v in self.exp_avg.items()},
                "exp_avg_sq": {k: v.clone()
                               for k, v in self.exp_avg_sq.items()}}

    def load_state_dict(self, state: dict):
        for steps in self.steps:
            for t in steps:
                t.fill_(float(state["step"]))
        for key in ("exp_avg", "exp_avg_sq"):
            mine = getattr(self, key)
            for k, v in state[key].items():
                mine[k].copy_(v)


def stacked_step_loss(model: StackedVAE, cfg: TrainConfig, xb_std, eps,
                      betas, spec=None):
    """Each config's loss of one minibatch, (C,): encode, reparameterize
    (one K4 launch), decode, and config c's ``recon + beta_c * mean(kl)``
    as ``trainer.step_loss`` forms it.  ``xb_std`` is (C, B, L) or C
    tensors (B, L), ``eps`` (C, B, k), ``betas`` C floats; ``spec`` is
    None or C (mean, std) pairs for the raw loss space."""
    mu, logvar = model.encode(xb_std)
    z, kl = model.reparameterize(mu, logvar, eps)
    spec = spec or [None] * model.n
    losses = []
    for x, x_rec, kl_c, beta, sp in zip(xb_std, model.decode_each(z),
                                        kl.unbind(0), betas, spec):
        x_cmp, r_cmp = _loss_pair(cfg, x, x_rec, sp)
        losses.append(recon_loss(x_cmp, r_cmp, cfg.loss_type)
                      + float(beta) * kl_c.mean())
    return torch.stack(losses)


def make_stacked_train_step(model: StackedVAE, opt: StackedAdam,
                            cfg: TrainConfig, betas, spec=None):
    """step(xb_std, eps) -> losses (C,) (the arguments as
    ``stacked_step_loss`` takes them): one Adam step of every config on
    the loss ``sum_c [recon_c + beta_c * mean(kl_c)]`` (each config's
    gradient is its own loss's)."""

    def step(xb_std, eps):
        model.train()
        losses = stacked_step_loss(model, cfg, xb_std, eps, betas, spec)
        opt.zero_grad()
        losses.sum().backward()
        opt.step()
        return losses.detach()

    return step


def make_stacked_eval_loss(model: StackedVAE, cfg: TrainConfig, betas,
                           spec=None):
    """eval_loss(x_std, eps) -> losses (C,) over whole sets (as
    ``stacked_step_loss`` takes them): eval-mode BatchNorm, z still drawn
    through K4."""

    def eval_loss(x_std, eps):
        model.eval()
        with torch.no_grad():
            return stacked_step_loss(model, cfg, x_std, eps, betas, spec)

    return eval_loss
