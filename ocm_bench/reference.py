"""The plain reference: ConvVAE1D and its VAE-SIMCA and latent-D^2
decisions, in plain PyTorch.

It imports torch and numpy only, and nothing of the program under test.
It makes its own weights and inputs from the run's seed (``data.py``), so
it shares no tensor with the program.  The layer equations are the
reference checkpoint's (``vae_model.py``): Conv1d with padding k // 2,
BatchNorm in eval mode on its running statistics, ELU, dense layers,
ConvTranspose1d with output padding stride - 1, a 1x1 output conv, the
decoder's output cropped or zero-padded to the input length.

Precision: float32 on the card with TF32 off for matmuls and cuDNN, as the
configurations state; the small latent statistics (k x k inverses,
limits) in float64.  ``tf32=True`` computes the network in TF32 instead:
that is the control, which the comparison has to fail.
"""

from __future__ import annotations

import contextlib
import math
from statistics import NormalDist

import numpy as np
import torch
import torch.nn.functional as F

from ocm_bench import data

BN_EPS = 1e-5


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on (the control) or off (the reference) for matmuls and cuDNN,
    restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def _bn(h, sd, key):
    """BatchNorm in eval mode on the running statistics, then ELU."""
    w, b = sd[f"{key}.weight"], sd[f"{key}.bias"]
    mean, var = sd[f"{key}.running_mean"], sd[f"{key}.running_var"]
    y = (h - mean[None, :, None]) / torch.sqrt(var[None, :, None] + BN_EPS)
    return F.elu(y * w[None, :, None] + b[None, :, None])


def encode(cfg, sd, x_std):
    """Standardized spectra (B, L) -> (mu, logvar)."""
    h = x_std[:, None, :]
    for lay in data.layers(cfg):
        if lay["part"] != "enc":
            continue
        key = lay["key"]
        if lay["kind"] == "conv":
            h = F.conv1d(h, sd[f"{key}.weight"], sd[f"{key}.bias"],
                         stride=lay["stride"], padding=lay["k"] // 2)
        elif lay["kind"] == "bn":
            h = _bn(h, sd, key)
        elif key == "fc.0":
            h = F.elu(F.linear(h.flatten(1), sd[f"{key}.weight"],
                               sd[f"{key}.bias"]))
    mu = F.linear(h, sd["fc_mu.weight"], sd["fc_mu.bias"])
    logvar = F.linear(h, sd["fc_logvar.weight"], sd["fc_logvar.bias"])
    return mu, logvar


def decode(cfg, sd, z):
    """Latent (B, k) -> standardized spectra (B, L)."""
    enc_ch, enc_len = data.encoder_shape(cfg)
    h = F.elu(F.linear(z, sd["fc_dec.0.weight"], sd["fc_dec.0.bias"]))
    h = F.elu(F.linear(h, sd["fc_dec.3.weight"], sd["fc_dec.3.bias"]))
    h = h.reshape(z.shape[0], enc_ch, enc_len)
    for lay in data.layers(cfg):
        if lay["part"] != "dec" or lay["kind"] == "dense":
            continue
        key = lay["key"]
        if lay["kind"] == "convt":
            h = F.conv_transpose1d(h, sd[f"{key}.weight"], sd[f"{key}.bias"],
                                   stride=lay["stride"],
                                   padding=lay["k"] // 2,
                                   output_padding=lay["stride"] - 1)
        elif lay["kind"] == "bn":
            h = _bn(h, sd, key)
        else:
            h = F.conv1d(h, sd[f"{key}.weight"], sd[f"{key}.bias"])
    out = h[:, 0, :]
    length = cfg["input_length"]
    if out.shape[1] >= length:
        return out[:, :length]
    return F.pad(out, (0, length - out.shape[1]))


# ---------------------------------------------------------------------------
# screening
# ---------------------------------------------------------------------------


def _spec_stats(x):
    return x.mean(0), x.std(0, unbiased=False) + 1e-12


def _inverse(cov64):
    return torch.linalg.pinv(cov64, hermitian=True)


def _maha(mu, mean64, inv64):
    d = mu.double() - mean64
    return ((d @ inv64) * d).sum(1)


def _quantile(v64, q):
    return float(np.percentile(v64.cpu().numpy(), 100.0 * q))


class ScreenModel:
    """One class's network, standardization and fitted decision state."""

    def __init__(self, cfg, variant, seed, cls, device):
        self.cfg, self.variant = cfg, variant
        self.sd = data.vae_weights(cfg, seed, (data.WEIGHTS, cls),
                                   device=device)
        x_cal = data.calibration_set(cfg, seed, cls, device)
        self.mean, self.std = _spec_stats(x_cal)
        mu, _ = encode(cfg, self.sd, self._std(x_cal))
        n, k = mu.shape
        mu64 = mu.double()
        self.latent_mean = mu64.mean(0)
        muc = mu64 - self.latent_mean
        if variant == "vaesimca":
            v = cfg["vaesimca"]
            cov = muc.T @ muc / (n - 1) + 1e-12 * torch.eye(
                k, dtype=torch.float64, device=device)
            self.inv = _inverse(cov)
            t2 = _maha(mu, self.latent_mean, self.inv)
            q = self._roundtrip_q(mu)
            self.t2_limit = k * (n - 1.0) / (n - k) * _quantile(t2, v["t2cl"])
            self.q_limit = _jm_limit(q.cpu().numpy(), v["qcl"])
            self.d_limit = math.sqrt(2.0)
            self.calib = {"t2_limit": self.t2_limit, "q_limit": self.q_limit}
        elif variant == "d2":
            cov = muc.T @ muc / (n - 1) + 1e-6 * torch.eye(
                k, dtype=torch.float64, device=device)
            self.inv = _inverse(cov)
            d2 = _maha(mu, self.latent_mean, self.inv)
            self.threshold = _quantile(d2, cfg["d2_percentile"] / 100.0)
            self.calib = {"threshold": self.threshold}
        else:
            raise ValueError(f"no reference for variant {variant!r}")

    def _std(self, x):
        return (x - self.mean) / self.std

    def _roundtrip_q(self, mu):
        # the decoder's standardized output is standardized once more
        # before it is encoded again (the reference's double
        # standardization)
        x_hat = self._std(decode(self.cfg, self.sd, mu))
        z_hat, _ = encode(self.cfg, self.sd, x_hat)
        return ((mu.double() - z_hat.double()) ** 2).sum(1)

    def score(self, x):
        """{'accept', statistics, 'margin'} of spectra (N, L) on the
        device, as float64 / bool tensors; ``margin`` is the decision's
        distance / limit - 1."""
        mu, _ = encode(self.cfg, self.sd, self._std(x))
        if self.variant == "vaesimca":
            t2 = _maha(mu, self.latent_mean, self.inv)
            q = self._roundtrip_q(mu)
            dist = torch.sqrt((t2 / self.t2_limit) ** 2
                              + (q / self.q_limit) ** 2)
            return {"accept": dist < self.d_limit, "t2": t2, "q": q,
                    "margin": dist / self.d_limit - 1.0}
        d2 = _maha(mu, self.latent_mean, self.inv)
        return {"accept": d2 <= self.threshold, "d2": d2,
                "margin": d2 / self.threshold - 1.0}


def _jm_limit(q, cl):
    """The Q limit 'jm' of the reference's VAE-SIMCA: Jackson-Mudholkar on
    the moments of the Q values themselves."""
    q = np.asarray(q, np.float64)
    t1, t2, t3 = q.sum(), (q * q).sum(), (q ** 3).sum()
    if t1 <= 0:
        return 0.0
    h0 = max(1.0 - 2.0 * t1 * t3 / (3.0 * t2 * t2), 1e-3)
    ca = NormalDist().inv_cdf(cl)
    h1 = ca * math.sqrt(2.0 * t2 * h0 * h0) / t1
    h2 = t2 * h0 * (h0 - 1.0) / (t1 * t1)
    return float(t1 * (1.0 + h1 + h2) ** (1.0 / h0))


def screen_classes(cfg, traffic) -> list[int]:
    """The class indices a screen decides against: the target alone, or
    every class."""
    if traffic["classes"] == "target":
        return [cfg["classes"].index(cfg["target"])]
    return list(range(len(cfg["classes"])))


class ScreenReference:
    """Every screened class's reference model; ``score`` gives the
    screen's outputs as numpy arrays with the scorer's layout ((N,) for one
    class, (N, C) for several)."""

    def __init__(self, cfg, traffic, seed, device, tf32=False):
        self.tf32 = tf32
        with torch.no_grad(), precision(tf32):
            self.models = [ScreenModel(cfg, traffic["variant"], seed, c,
                                       device)
                           for c in screen_classes(cfg, traffic)]
        self.block = cfg["chunk_size"]
        self.device = device

    @property
    def calib(self) -> dict:
        keys = self.models[0].calib
        return {k: np.array([m.calib[k] for m in self.models]) for k in keys}

    def score(self, x) -> dict:
        outs = []
        with torch.no_grad(), precision(self.tf32):
            for s in range(0, x.shape[0], self.block):
                xb = torch.as_tensor(x[s:s + self.block], device=self.device)
                per = [m.score(xb) for m in self.models]
                outs.append({k: torch.stack([p[k] for p in per], 1)
                             .cpu().numpy() for k in per[0]})
        out = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        if len(self.models) == 1:
            out = {k: v[:, 0] for k, v in out.items()}
        return out
