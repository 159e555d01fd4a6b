"""ConvVAE1D, the 1-D convolutional beta-VAE, and its losses.

Port of ``ocm_tpu/models/vae.py``.  The module's state-dict keys are the
reference checkpoint's (``encoder_conv.N``, ``fc.0``, ``fc_mu``,
``fc_logvar``, ``fc_dec.0``, ``fc_dec.3``, ``decoder_conv.N``; see
``ocm_tpu/models/torch_export.py``), and ``vae_state_dict_from_numpy``
carries a JAX-trained flax parameter tree, as numpy arrays, across into
them.

Training-mode BatchNorm + activation runs through ``fused_bn_act`` (kernels
K2/K3 on the card) and the reparameterization through
``fused_reparam_kl`` (K4), or, for a forward given a seed instead of
noise, through ``reparam_kl_sample`` (K5, noise drawn in the kernel).
Eval-mode BatchNorm normalises with the running statistics, as the JAX
module does: in ``encode`` and ``decode``, each conv block runs as the
convolution without its bias and one ``bn_act_eval``, which adds the bias,
normalises and activates in one pass of kernel K9, where K9 has the block
to compute (float32 on the card, outside autograd and autocast), and as
the modules themselves, in plain elementwise torch, everywhere else
(``conv_bn_act_eval``).
BatchNorm follows flax, not ``nn.BatchNorm1d``: the running update is
``0.9 * running + 0.1 * batch`` with the biased fast variance.
Convolutions and dense layers are ``torch.nn.functional`` calls (cuDNN and
cuBLAS on the card); the VAE's f32 agreement with the reference needs
TF32 off for both (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ocm_tpu_torch.ops import bn as bn_ops
from ocm_tpu_torch.ops.bn import (apply_act, bn_act_normalize,
                                  cross_replica_bn_act, fused_bn_act)
from ocm_tpu_torch.ops.kernels import fused_reparam_kl, reparam_kl_sample
from ocm_tpu_torch.utils import profiling


def conv_out_length(length: int, kernel_size: int, stride: int) -> int:
    """torch Conv1d length with padding=k//2."""
    padding = kernel_size // 2
    return (length + 2 * padding - (kernel_size - 1) - 1) // stride + 1


def encoder_shapes(input_length: int, conv_blocks: int, n_filters: int,
                   kernel_size: int, stride: int):
    """(channels, length) after the encoder conv stack."""
    out_len, in_ch, filters = input_length, 1, n_filters
    for b in range(conv_blocks):
        out_len = conv_out_length(out_len, kernel_size, 1 if b == 0 else stride)
        in_ch = filters
        filters = min(filters * 2, 1024)
    return in_ch, out_len


class Act(nn.Module):
    """ELU or exact GELU (torch's ``nn.GELU`` default)."""

    def __init__(self, act: str):
        super().__init__()
        self.act = act

    def forward(self, x):
        return apply_act(x, self.act)


class _DropoutRng:
    """The generator the model's dropout masks come from (None: torch's
    default generator of the tensor's device)."""

    generator = None


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep with probability 1 - p, scale by 1/(1 - p),
    with the mask drawn from the owning model's generator."""

    def __init__(self, p: float, rng: _DropoutRng):
        super().__init__()
        self.p, self.rng = p, rng

    def forward(self, x):
        if not self.training or self.p <= 0:
            return x
        keep = 1.0 - self.p
        u = torch.rand(x.shape, generator=self.rng.generator,
                       device=x.device, dtype=x.dtype)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class BatchNormAct(nn.Module):
    """BatchNorm + activation with flax semantics.

    Parameters ``weight``/``bias``, buffers ``running_mean``/``running_var``
    (f32) and ``num_batches_tracked``.  Training: ``fused_bn_act`` and the
    running update ``m * running + (1 - m) * batch`` (m = 0.9, biased fast
    variance).  Eval: the running statistics through ``bn_act_normalize``.

    ``axis_name`` (flax's ``axis_name``): training statistics averaged over
    the data-parallel ranks of that mesh axis through ``cross_replica_bn_act``
    and the ``pmean`` that ``parallel.train_dist`` binds; such a layer
    trains only inside a data-parallel step.
    """

    def __init__(self, num_features: int, act: str = "elu",
                 momentum: float = 0.9, eps: float = 1e-5,
                 axis_name: str | None = None):
        super().__init__()
        self.act, self.momentum, self.eps = act, momentum, eps
        self.axis_name, self.pmean = axis_name, None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        if not self.training:
            return bn_act_normalize(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, self.eps,
                                    self.act)
        if self.axis_name is None:
            out, mean, var = fused_bn_act(x, self.weight, self.bias,
                                          self.eps, self.act)
        elif self.pmean is None:
            raise RuntimeError(
                f"BatchNorm with axis_name={self.axis_name!r} trains only in "
                "a data-parallel step over a mesh with that axis "
                "(parallel.train_dist.make_dp_train_step)")
        else:
            out, mean, var = cross_replica_bn_act(
                x, self.weight, self.bias, self.eps, self.act, self.pmean)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
            self.num_batches_tracked += 1
        return out


def _conv_without_bias(conv, h):
    """What ``conv`` (a Conv1d or ConvTranspose1d) computes from h, less its
    bias: the call its ``forward`` makes, with the bias left out."""
    if isinstance(conv, nn.ConvTranspose1d):
        return F.conv_transpose1d(h, conv.weight, None, conv.stride,
                                  conv.padding, conv.output_padding,
                                  conv.groups, conv.dilation)
    return F.conv1d(h, conv.weight, None, conv.stride, conv.padding,
                    conv.dilation, conv.groups)


def conv_bn_act_eval(conv, norm: BatchNormAct, h):
    """An eval-mode conv block, ``norm(conv(h))``.  Where K9 has the block's
    epilogue to compute (``ops.bn.eval_kernel_applies``), the convolution
    runs without its bias and ``bn_act_eval`` adds it, normalises and
    activates in the kernel's one pass over the conv's output; elsewhere
    the two modules run as they are.  The choice adds 1 to the counter
    ``model.bn_act_eval_fused`` or ``model.bn_act_eval_plain``
    (``utils.profiling.count``, recorded while tracing).  On the card,
    where torch adds a convolution's bias in a pass of its own, both give
    the same bits with ELU and none, and agree within 2 ulp with GELU."""
    if bn_ops.eval_kernel_applies(h, conv.weight, conv.bias, norm.weight,
                                  norm.bias, norm.running_mean,
                                  norm.running_var):
        profiling.count("model.bn_act_eval_fused", 1)
        return bn_ops.bn_act_eval(_conv_without_bias(conv, h), conv.bias,
                                  norm.running_mean, norm.running_var,
                                  norm.weight, norm.bias, norm.eps, norm.act)
    profiling.count("model.bn_act_eval_plain", 1)
    return norm(conv(h))


class ConvVAE1D(nn.Module):
    """One-class spectral beta-VAE on standardized spectra (B, input_length).

    Weights are Kaiming-normal with the reference's fans (conv: in_ch * k,
    transposed conv: out_ch * k, linear: in_features; gain sqrt(2) for
    ``init_nonlinearity='relu'``, else 1), biases zero, drawn on the CPU
    from ``generator`` (default: seeded 0), so one seed gives one model on
    any device.

    ``bn_axis_name`` (the reference's): the BatchNorm layers average their
    training statistics over the ranks of that mesh axis
    (``parallel.train_dist``).
    """

    def __init__(self, input_length: int, latent_dim: int,
                 conv_blocks: int = 3, n_filters: int = 32,
                 kernel_size: int = 9, stride: int = 2, hidden_fc: int = 256,
                 activation: str = "elu", dropout: float = 0.0,
                 use_batchnorm: bool = True, init_nonlinearity: str = "linear",
                 generator: torch.Generator | None = None,
                 bn_axis_name: str | None = None):
        super().__init__()
        self.bn_axis_name = bn_axis_name
        if activation not in ("elu", "gelu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.input_length, self.latent_dim = input_length, latent_dim
        self.conv_blocks, self.n_filters = conv_blocks, n_filters
        self.kernel_size, self.stride = kernel_size, stride
        self.hidden_fc, self.activation = hidden_fc, activation
        self.dropout, self.use_batchnorm = dropout, use_batchnorm
        self.init_nonlinearity = init_nonlinearity
        self._rng = _DropoutRng()
        k, pad = kernel_size, kernel_size // 2
        self.enc_shape = encoder_shapes(input_length, conv_blocks, n_filters,
                                        kernel_size, stride)
        enc_ch, enc_len = self.enc_shape
        fc_in = enc_ch * enc_len

        enc, in_ch, filters = [], 1, n_filters
        for b in range(conv_blocks):
            enc.append(nn.Conv1d(in_ch, filters, k, 1 if b == 0 else stride,
                                 pad))
            enc += self._bn_act_drop(filters)
            in_ch, filters = filters, min(filters * 2, 1024)
        self.encoder_conv = nn.Sequential(*enc)
        self.fc = nn.Sequential(nn.Linear(fc_in, hidden_fc), Act(activation),
                                self._drop())
        self.fc_mu = nn.Linear(hidden_fc, latent_dim)
        self.fc_logvar = nn.Linear(hidden_fc, latent_dim)
        self.fc_dec = nn.Sequential(
            nn.Linear(latent_dim, hidden_fc), Act(activation), self._drop(),
            nn.Linear(hidden_fc, fc_in), Act(activation))
        dec, filters = [], enc_ch
        for b in range(conv_blocks):
            nxt = max(filters // 2, n_filters)
            s = stride if b < conv_blocks - 1 else 1
            dec.append(nn.ConvTranspose1d(filters, nxt, k, s, pad,
                                          output_padding=s - 1))
            dec += self._bn_act_drop(nxt)
            filters = nxt
        dec.append(nn.Conv1d(filters, 1, 1))
        self.decoder_conv = nn.Sequential(*dec)
        self._init_weights(generator, init_nonlinearity)

    def _drop(self):
        return Dropout(self.dropout, self._rng) if self.dropout > 0 \
            else nn.Identity()

    def _bn_act_drop(self, channels):
        """The reference's [BatchNorm1d,] act[, Dropout] after a conv; the
        activation is fused into BatchNormAct, and an Identity keeps its
        index so that the state-dict keys are the reference's."""
        layers = ([BatchNormAct(channels, self.activation,
                                axis_name=self.bn_axis_name), nn.Identity()]
                  if self.use_batchnorm else [Act(self.activation)])
        return layers + ([self._drop()] if self.dropout > 0 else [])

    @torch.no_grad()
    def _init_weights(self, generator, nonlinearity):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        gain = math.sqrt(2.0) if nonlinearity == "relu" else 1.0
        for mod in self.modules():
            if isinstance(mod, nn.ConvTranspose1d):
                fan_in = mod.out_channels * mod.kernel_size[0]
            elif isinstance(mod, nn.Conv1d):
                fan_in = mod.in_channels * mod.kernel_size[0]
            elif isinstance(mod, nn.Linear):
                fan_in = mod.in_features
            else:
                continue
            mod.weight.copy_(torch.randn(mod.weight.shape,
                                         generator=generator)
                             * (gain / math.sqrt(fan_in)))
            mod.bias.zero_()

    @property
    def dropout_generator(self):
        return self._rng.generator

    @dropout_generator.setter
    def dropout_generator(self, generator):
        """The generator dropout masks are drawn from (None: torch's
        default generator of the input's device)."""
        self._rng.generator = generator

    def _conv_stack(self, layers: nn.Sequential, h):
        """``layers(h)``; in eval mode, each conv followed by a
        ``BatchNormAct`` runs as one ``conv_bn_act_eval``."""
        if self.training or not self.use_batchnorm:
            return layers(h)
        mods, i = list(layers), 0
        while i < len(mods):
            if i + 1 < len(mods) and isinstance(mods[i + 1], BatchNormAct):
                h = conv_bn_act_eval(mods[i], mods[i + 1], h)
                i += 2
            else:
                h = mods[i](h)
                i += 1
        return h

    def encode(self, x):
        """Standardized spectra (B, L) -> (mu, logvar)."""
        h = self._conv_stack(self.encoder_conv, x.unsqueeze(1)).flatten(1)
        h = self.fc(h)
        return self.fc_mu(h), self.fc_logvar(h)

    def reparameterize(self, mu, logvar, eps):
        """(z, kl_per_sample): z = mu + eps * exp(logvar / 2), fused (K4)."""
        return fused_reparam_kl(mu, logvar, eps)

    def decode(self, z):
        """Latent (B, k) -> standardized spectra (B, L), cropped or
        zero-padded to ``input_length``."""
        h = self.fc_dec(z).view(z.shape[0], *self.enc_shape)
        x_rec = self._conv_stack(self.decoder_conv, h).squeeze(1)
        out_len = x_rec.shape[-1]
        if out_len > self.input_length:
            return x_rec[..., :self.input_length]
        return F.pad(x_rec, (0, self.input_length - out_len))

    def forward(self, x, eps=None, seed=None):
        """(x_rec, mu, logvar).  Pass exactly one of ``eps``, the noise
        (B, latent_dim), reparameterized through K4/K6 as in training, or
        ``seed``, an unsigned 64-bit integer from which kernel K5 draws the
        noise itself (inference only: no gradient)."""
        if (eps is None) == (seed is None):
            raise ValueError("pass exactly one of eps (the noise) or seed "
                             "(noise drawn in the kernel)")
        mu, logvar = self.encode(x)
        if eps is not None:
            z, _ = self.reparameterize(mu, logvar, eps)
        else:
            z, _ = reparam_kl_sample(mu, logvar, seed)
        return self.decode(z), mu, logvar


def vae_state_dict_from_numpy(params, batch_stats, model: ConvVAE1D) -> dict:
    """A JAX ``ConvVAE1D``'s flax tree (``params``, ``batch_stats``; numpy
    leaves) as this module's state dict of CPU tensors.

    The layout transforms are those of ``ocm_tpu/models/torch_export.py``:
    conv kernel (k, in, out) -> (out, in, k); transposed-conv kernel flipped
    along k, then (k, in, out) -> (in, out, k); and the flatten order of the
    two dense layers that touch the flattened conv activation, which JAX
    flattens as (L', C) and torch as (C, L').
    """
    batch_stats = batch_stats or {}
    state: dict = {}

    def put(prefix, w, b):
        state[f"{prefix}.weight"] = np.ascontiguousarray(w)
        state[f"{prefix}.bias"] = np.ascontiguousarray(b)

    def conv(p):
        return np.asarray(p["kernel"]).transpose(2, 1, 0), np.asarray(p["bias"])

    def conv_t(p):
        kern = np.asarray(p["kernel"])[::-1]
        return kern.transpose(1, 2, 0), np.asarray(p["bias"])

    def dense(p):
        return np.asarray(p["kernel"]).T, np.asarray(p["bias"])

    def put_bn(prefix, name):
        put(prefix, np.asarray(params[name]["scale"]),
            np.asarray(params[name]["bias"]))
        state[f"{prefix}.running_mean"] = np.asarray(batch_stats[name]["mean"])
        state[f"{prefix}.running_var"] = np.asarray(batch_stats[name]["var"])
        state[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)

    step = 2 + int(model.use_batchnorm) + int(model.dropout > 0)
    for b in range(model.conv_blocks):
        put(f"encoder_conv.{b * step}", *conv(params[f"enc_conv{b}"]))
        if model.use_batchnorm:
            put_bn(f"encoder_conv.{b * step + 1}", f"enc_bn{b}")
    enc_ch, enc_len = model.enc_shape
    k_fc = np.asarray(params["fc"]["kernel"])            # (L' * C, hidden)
    put("fc.0", k_fc.T.reshape(-1, enc_len, enc_ch).transpose(0, 2, 1)
        .reshape(k_fc.shape[1], -1), np.asarray(params["fc"]["bias"]))
    put("fc_mu", *dense(params["fc_mu"]))
    put("fc_logvar", *dense(params["fc_logvar"]))
    put("fc_dec.0", *dense(params["fc_dec0"]))
    k_d = np.asarray(params["fc_dec1"]["kernel"])        # (hidden, L' * C)
    put("fc_dec.3", k_d.T.reshape(enc_len, enc_ch, -1).transpose(1, 0, 2)
        .reshape(enc_len * enc_ch, -1),
        np.asarray(params["fc_dec1"]["bias"]).reshape(enc_len, enc_ch).T
        .reshape(-1))
    for b in range(model.conv_blocks):
        put(f"decoder_conv.{b * step}", *conv_t(params[f"dec_conv{b}"]))
        if model.use_batchnorm:
            put_bn(f"decoder_conv.{b * step + 1}", f"dec_bn{b}")
    put(f"decoder_conv.{model.conv_blocks * step}", *conv(params["dec_out"]))
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def vae_state_dict_to_numpy(state_dict, model: ConvVAE1D):
    """The inverse of ``vae_state_dict_from_numpy``: this module's state
    dict as a JAX ``ConvVAE1D``'s flax trees ``(params, batch_stats)`` of
    numpy arrays (``batch_stats`` empty without BatchNorm)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    params: dict = {}
    batch_stats: dict = {}

    def conv(prefix):
        return {"kernel": np.ascontiguousarray(
                    sd[f"{prefix}.weight"].transpose(2, 1, 0)),
                "bias": sd[f"{prefix}.bias"]}

    def conv_t(prefix):
        return {"kernel": np.ascontiguousarray(
                    sd[f"{prefix}.weight"].transpose(2, 0, 1)[::-1]),
                "bias": sd[f"{prefix}.bias"]}

    def dense(prefix):
        return {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T),
                "bias": sd[f"{prefix}.bias"]}

    def bn(prefix, name):
        params[name] = {"scale": sd[f"{prefix}.weight"],
                        "bias": sd[f"{prefix}.bias"]}
        batch_stats[name] = {"mean": sd[f"{prefix}.running_mean"],
                             "var": sd[f"{prefix}.running_var"]}

    step = 2 + int(model.use_batchnorm) + int(model.dropout > 0)
    enc_ch, enc_len = model.enc_shape
    for b in range(model.conv_blocks):
        params[f"enc_conv{b}"] = conv(f"encoder_conv.{b * step}")
        if model.use_batchnorm:
            bn(f"encoder_conv.{b * step + 1}", f"enc_bn{b}")
    w_fc = sd["fc.0.weight"]                            # (hidden, C * L')
    params["fc"] = {"kernel": np.ascontiguousarray(
        w_fc.reshape(-1, enc_ch, enc_len).transpose(0, 2, 1)
        .reshape(w_fc.shape[0], -1).T), "bias": sd["fc.0.bias"]}
    params["fc_mu"] = dense("fc_mu")
    params["fc_logvar"] = dense("fc_logvar")
    params["fc_dec0"] = dense("fc_dec.0")
    w_d = sd["fc_dec.3.weight"]                         # (C * L', hidden)
    params["fc_dec1"] = {
        "kernel": np.ascontiguousarray(
            w_d.reshape(enc_ch, enc_len, -1).transpose(1, 0, 2)
            .reshape(enc_len * enc_ch, -1).T),
        "bias": np.ascontiguousarray(
            sd["fc_dec.3.bias"].reshape(enc_ch, enc_len).T.reshape(-1))}
    for b in range(model.conv_blocks):
        params[f"dec_conv{b}"] = conv_t(f"decoder_conv.{b * step}")
        if model.use_batchnorm:
            bn(f"decoder_conv.{b * step + 1}", f"dec_bn{b}")
    params["dec_out"] = conv(f"decoder_conv.{model.conv_blocks * step}")
    return params, batch_stats


# ---------------------------------------------------------------------------
# beta-VAE losses
# ---------------------------------------------------------------------------

LOSS_NAMES = ("cosine", "bce", "euclidean", "bce_prob")


def kl_divergence(mu, logvar):
    """KL(q || N(0, I)) = -1/2 * mean(sum(1 + logvar - mu^2 - e^logvar))."""
    return -0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar)).sum(1).mean()


def cosine_recon_loss(x, x_rec, eps: float = 1e-8):
    """Chord distance mean(sqrt(2 (1 - cos))); rows normalised as
    ``F.normalize`` does (norm clamped at 1e-12), cos clamped to
    [-1 + eps, 1 - eps]."""
    xn = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
    rn = x_rec / torch.linalg.vector_norm(x_rec, dim=1,
                                          keepdim=True).clamp_min(1e-12)
    cos = (xn * rn).sum(1).clamp(-1.0 + eps, 1.0 - eps)
    return torch.sqrt(2.0 * (1.0 - cos)).mean()


def _minmax_target(x, eps):
    x_min = x.min(1, keepdim=True).values
    x_max = x.max(1, keepdim=True).values
    return x_min, x_max, ((x - x_min) / (x_max - x_min + eps)).clamp(0.0, 1.0)


def bce_logits_recon_loss(x, x_rec, eps: float = 1e-8):
    """BCE-with-logits of x_rec against the per-sample min-max-scaled x."""
    _, _, t = _minmax_target(x, eps)
    per_elem = (x_rec.clamp_min(0.0) - x_rec * t
                + torch.log1p(torch.exp(-x_rec.abs())))
    return per_elem.mean()


def euclidean_recon_loss(x, x_rec):
    """Mean squared error."""
    return ((x - x_rec) ** 2).mean()


def bce_prob_recon_loss(x, x_rec, eps: float = 1e-8):
    """Probability-space BCE with x and x_rec scaled by x's min/max;
    probabilities clipped to [1e-7, 1 - 1e-7]."""
    x_min, x_max, t = _minmax_target(x, eps)
    p = ((x_rec - x_min) / (x_max - x_min + eps)).clamp(1e-7, 1.0 - 1e-7)
    return (-(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))).mean()


_RECON_LOSSES = {
    "cosine": cosine_recon_loss,
    "bce": bce_logits_recon_loss,
    "euclidean": euclidean_recon_loss,
    "bce_prob": bce_prob_recon_loss,
}


def recon_loss(x, x_rec, loss_type: str = "cosine"):
    """The reconstruction term named by ``loss_type``."""
    if loss_type not in _RECON_LOSSES:
        raise ValueError(
            f"unknown loss_type {loss_type!r}; expected one of {LOSS_NAMES}")
    return _RECON_LOSSES[loss_type](x, x_rec)


def beta_vae_loss(x, x_rec, mu, logvar, beta: float = 1.0,
                  loss_type: str = "cosine"):
    """(total, recon, kl) with total = recon + beta * kl."""
    recon = recon_loss(x, x_rec, loss_type)
    kl = kl_divergence(mu, logvar)
    return recon + beta * kl, recon, kl
