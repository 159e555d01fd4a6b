"""Training-mode BatchNorm + activation, fused into one kernel each way.

Port of ``ocm_tpu/ops/bn.py``.  ``fused_bn_act`` is a
``torch.autograd.Function`` whose forward is kernel K2 (``bn_act_fwd``,
port of ``_bn_fwd_pallas``, ``bn.py:126``) and whose backward is kernel K3
(``bn_act_bwd``, port of ``_bn_bwd_pallas``, ``bn.py:147``), both in
``ocm_tpu_torch/csrc/bn_act.cu``.  Semantics are flax's
``BatchNorm(use_fast_variance=True)`` followed by the activation: f32
batch statistics, the fast variance ``max(E[x^2] - E[x]^2, 0)``, and
``y = (x - mean) * (rsqrt(var + eps) * gamma) + beta``.

Layout: torch's conv layout (B, C, L); statistics are taken over every
axis but 1, with no relayout (JAX's module is channels-last, ``(..., C)``).
K2 and K3 are each one launch of thread block clusters: each channel is
split over the ``k2_cluster_size`` blocks of one cluster, which add their
partial sums through distributed shared memory and then write out (K2) or
dx (K3) from registers (one read of x, and of dout).
The kernels take float32, contiguous, 3-d tensors; on a CPU tensor the
wrappers compute the plain twins ``bn_act_fwd_plain``/``bn_act_bwd_plain``
(same formulas), on a CUDA tensor they launch or raise.  There is no size
gate: the card has no counterpart of the TPU kernel's VMEM budget.

``bn_act_eval`` is the eval-mode epilogue of a convolution: its bias,
BatchNorm with the running statistics, and the activation, in one pass of
kernel K9 (``bn_act_eval_f32``, the same source) over a contiguous f32
CUDA tensor; ``eval_kernel_applies`` says where K9 has it to compute
(float32 on the card, outside autograd and autocast), and the callers run
the modules' eager chain elsewhere.  K9 gives the chain's bits with ELU
and none, and exact GELU within 2 ulp of torch's.

``cross_replica_bn_act`` is the data-parallel form (``ocm_tpu``'s
``bn_axis_name``, ``bn.py:173-183``): the batch mean and mean square are
averaged over ranks by the caller's ``pmean``, and the backward averages
their cotangents the same way (the ``SyncBatchNorm`` pattern).  As in the
reference, it runs the plain twin: the reduction sits between the
statistics and the normalization, inside no single kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ocm_tpu_torch.ops import _build
from ocm_tpu_torch.ops.kernels import check_cuda_tensors, stream_of

ACTS = ("elu", "gelu", "none")
# K2's and K3's launch (csrc/bn_act.cu): threads a block, elements a thread
# keeps in registers (of x, and of dout in K3), the largest portable
# cluster, and the blocks it aims for (two a SM of an H100's 132)
K2_THREADS, K2_ITEMS, K2_MAX_CLUSTER, K2_BLOCKS = 256, 16, 8, 256
# the most elements one launch of K9 (bn_act_eval_fused) takes: it
# indexes the flat (B, C, L) array in 32 bits
K9_MAX_ELEMENTS = 2**31 - 1


def _act_code(act: str) -> int:
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; expected one of {ACTS}")
    return ACTS.index(act)


def apply_act(y, act: str):
    """ELU, exact GELU or identity."""
    _act_code(act)
    if act == "elu":
        return F.elu(y)
    if act == "gelu":
        return F.gelu(y, approximate="none")
    return y


def act_grad(y, act: str):
    """d act(y) / dy evaluated at pre-activation y."""
    _act_code(act)
    if act == "elu":
        return torch.where(y > 0, torch.ones_like(y), torch.exp(y))
    if act == "gelu":
        # exact GELU': Phi(y) + y * phi(y)
        phi = torch.exp(-0.5 * y * y) * (1.0 / math.sqrt(2.0 * math.pi))
        cdf = 0.5 * (1.0 + torch.erf(y / math.sqrt(2.0)))
        return cdf + y * phi
    return torch.ones_like(y)


def _stat_dims(x):
    return [0] + list(range(2, x.dim()))


def _per_channel(v, x):
    """(C,) -> broadcastable against x (B, C, ...)."""
    return v.reshape((1, -1) + (1,) * (x.dim() - 2))


def bn_act_stats(x):
    """Batch mean and fast variance of (B, C, ...) over every axis but 1,
    in at least float32."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = _stat_dims(x)
    mean = xf.mean(dims)
    mean2 = (xf * xf).mean(dims)
    return mean, (mean2 - mean * mean).clamp_min(0.0)


def bn_act_normalize(x, mean, var, gamma, beta, eps: float, act: str,
                     dtype=None):
    """act((x - mean) * (rsqrt(var + eps) * gamma) + beta), flax's op order."""
    f = mean.dtype
    mul = torch.rsqrt(var + eps) * gamma.to(f)
    y = ((x.to(f) - _per_channel(mean, x)) * _per_channel(mul, x)
         + _per_channel(beta.to(f), x))
    return apply_act(y, act).to(dtype or x.dtype)


def bn_act_fwd_plain(x, gamma, beta, eps: float, act: str):
    """Plain twin of K2: (out, mean, var)."""
    mean, var = bn_act_stats(x)
    return bn_act_normalize(x, mean, var, gamma, beta, eps, act), mean, var


def bn_act_bwd_plain(x, gamma, beta, mean, var, dout, eps: float, act: str):
    """Plain twin of K3: (dx, dgamma, dbeta) from the saved inputs."""
    f = mean.dtype
    rstd = torch.rsqrt(var + eps)
    xhat = (x.to(f) - _per_channel(mean, x)) * _per_channel(rstd, x)
    y = xhat * _per_channel(gamma.to(f), x) + _per_channel(beta.to(f), x)
    dy = dout.to(f) * act_grad(y, act)
    dims = _stat_dims(x)
    dbeta = dy.sum(dims)
    dgamma = (dy * xhat).sum(dims)
    inv_n = 1.0 / (x.numel() // x.shape[1])
    dx = _per_channel(rstd * gamma.to(f), x) * (
        dy - _per_channel(dbeta * inv_n, x) - xhat * _per_channel(
            dgamma * inv_n, x))
    return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


def _check(what, x, channel_vectors, like_x=None):
    """x and each tensor of ``like_x`` contiguous f32 (B, C, L) CUDA tensors
    of one shape, each of ``channel_vectors`` of shape (C,)."""
    like_x = like_x or {}
    check_cuda_tensors(what, {
        "x": (x, 3), **{k: (v, 3) for k, v in like_x.items()},
        **{k: (v, 1) for k, v in channel_vectors.items()}})
    c = x.shape[1]
    for name, v in like_x.items():
        if v.shape != x.shape:
            raise ValueError(f"{what}: {name} has shape {tuple(v.shape)}, "
                             f"not that of x {tuple(x.shape)}")
    for name, v in channel_vectors.items():
        if v.shape != (c,):
            raise ValueError(f"{what}: {name} has shape {tuple(v.shape)}, "
                             f"expected ({c},) for x {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"{what}: empty batch {tuple(x.shape)}")


def k2_cluster_size(nb: int, nc: int, nl: int) -> int:
    """Blocks K2 and K3 split each channel of a (nb, nc, nl) batch over: the
    smallest power of two (at most 8, the portable cluster size, so that a
    cluster's blocks are always co-resident) that gives ``K2_BLOCKS``
    blocks in all and a share of at most ``K2_ITEMS`` elements a thread,
    halved again while a block would get less than one element a thread.
    8 at C 32, 4 at C 64, 2 at C 128 for the train step's B*L."""
    n = nb * nl
    size = 1
    while size < K2_MAX_CLUSTER and (
            nc * size < K2_BLOCKS or -(-n // size) > K2_ITEMS * K2_THREADS):
        size *= 2
    while size > 1 and n < size * K2_THREADS:
        size //= 2
    return size


def bn_act_fwd(x, gamma, beta, eps: float = 1e-5, act: str = "elu",
               cluster=None):
    """K2: training-mode BatchNorm + activation of x (B, C, L).

    Returns (out, mean, var), mean/var the (C,) batch statistics.  CPU
    tensors: the plain twin; CUDA tensors: the kernel on the current
    stream, one launch of C clusters of ``cluster`` blocks (default
    ``k2_cluster_size`` of x's shape; a channel's sums depend only on the
    cluster size, B and L, so channels stacked from several models keep
    each model's split when given its size).
    """
    code = _act_code(act)
    if x.device.type == "cpu":
        return bn_act_fwd_plain(x, gamma, beta, eps, act)
    _check("bn_act_fwd", x, {"gamma": gamma, "beta": beta})
    nb, nc, nl = x.shape
    out = torch.empty_like(x)
    mean = torch.empty((nc,), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        err = _build.library().bn_act_fwd_f32(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            mean.data_ptr(), var.data_ptr(), nb, nc, nl, eps, code,
            cluster or k2_cluster_size(nb, nc, nl), stream_of(x))
    _build.check(err, "bn_act_fwd")
    bn_act_fwd.launches += 1
    return out, mean, var


bn_act_fwd.launches = 0


def bn_act_bwd(x, gamma, beta, mean, var, dout, eps: float = 1e-5,
               act: str = "elu", cluster=None):
    """K3: gradient of ``bn_act_fwd``'s out w.r.t. x, gamma and beta.

    Returns (dx, dgamma, dbeta).  CPU tensors: the plain twin; CUDA
    tensors: the kernel on the current stream, one launch of C clusters of
    ``cluster`` (default ``k2_cluster_size``) blocks, as K2's.
    """
    code = _act_code(act)
    if x.device.type == "cpu":
        return bn_act_bwd_plain(x, gamma, beta, mean, var, dout, eps, act)
    _check("bn_act_bwd", x, {"gamma": gamma, "beta": beta, "mean": mean,
                             "var": var}, {"dout": dout})
    nb, nc, nl = x.shape
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(beta)
    with torch.cuda.device(x.device):
        err = _build.library().bn_act_bwd_f32(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
            var.data_ptr(), dout.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), nb, nc, nl, eps, code,
            cluster or k2_cluster_size(nb, nc, nl), stream_of(x))
    _build.check(err, "bn_act_bwd")
    bn_act_bwd.launches += 1
    return dx, dgamma, dbeta


bn_act_bwd.launches = 0


def eval_kernel_applies(x, *params) -> bool:
    """Whether K9 computes the eval epilogue of x: a float32 CUDA tensor,
    outside autocast, with nothing for autograd to record (grad mode off,
    or neither x nor any of ``params`` requires grad), and each of
    ``params`` (None or a tensor) float32 on x's device.  Elsewhere (the
    CPU, float64, the bf16 twin's autocast, a graph to record) the kernel
    has nothing to compute and the modules' own eager chain runs."""
    if not x.is_cuda or x.dtype != torch.float32 \
            or torch.is_autocast_enabled(x.device.type):
        return False
    grad = torch.is_grad_enabled()
    for t in (x, *params):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != x.device \
                or (grad and t.requires_grad):
            return False
    return True


def bn_act_eval_plain(x, conv_bias, mean, var, gamma, beta, eps: float,
                      act: str):
    """Plain twin of ``bn_act_eval``: the eager chain, x + conv_bias (None:
    nothing added), then ``bn_act_normalize``."""
    if conv_bias is not None:
        x = x + _per_channel(conv_bias, x)
    return bn_act_normalize(x, mean, var, gamma, beta, eps, act)


def bn_act_eval_fused(x, conv_bias, mean, mul, beta, act: str = "elu",
                      out=None):
    """K9: act(((x + conv_bias) - mean) * mul + beta) of x (B, C, L) on the
    current stream, into ``out`` (default: x itself, in place); conv_bias,
    mean, mul, beta (C,), ``mul`` being ``rsqrt(var + eps) * gamma``.
    Returns ``out``.  The kernel indexes in 32 bits, so a batch of more
    than ``K9_MAX_ELEMENTS`` elements runs as one launch per slice of rows
    that fits.  Each operation is rounded as the eager chain rounds it, so
    with ELU and none the result equals the chain's bit for bit; exact
    GELU agrees with torch's within 2 ulp."""
    code = _act_code(act)
    if x.device.type != "cuda":
        raise ValueError(f"bn_act_eval_fused launches on CUDA tensors, not "
                         f"{x.device}; bn_act_eval_plain is its CPU twin")
    out = x if out is None else out
    vectors = {"conv_bias": conv_bias, "mean": mean, "mul": mul,
               "beta": beta}
    if x.dim() != 3 or out.shape != x.shape or x.numel() == 0:
        _check("bn_act_eval", x, vectors, {"out": out})
    nb, nc, nl = x.shape
    if nc * nl > K9_MAX_ELEMENTS:
        raise ValueError(f"bn_act_eval: one row of {tuple(x.shape)} holds "
                         f"more than {K9_MAX_ELEMENTS} elements")
    rows = K9_MAX_ELEMENTS // (nc * nl)
    slices = [(x[b:b + rows], out[b:b + rows])
              for b in range(0, max(nb, 1), rows)]
    for xs, outs in slices:
        _check("bn_act_eval", xs, vectors, {"out": outs})
    lib = _build.library()
    with torch.cuda.device(x.device):
        for xs, outs in slices:
            err = lib.bn_act_eval_f32(
                xs.data_ptr(), conv_bias.data_ptr(), mean.data_ptr(),
                mul.data_ptr(), beta.data_ptr(), outs.data_ptr(),
                xs.shape[0], nc, nl, code, stream_of(x))
            _build.check(err, "bn_act_eval")
            bn_act_eval.launches += 1
    return out


def bn_act_eval(x, conv_bias, mean, var, gamma, beta, eps: float = 1e-5,
                act: str = "elu"):
    """Eval-mode conv epilogue: act(((x + conv_bias) - mean) * rsqrt(var +
    eps) * gamma + beta) of x (B, C, L), the output of a convolution run
    without its bias (``conv_bias`` None: nothing to add), with BatchNorm's
    running statistics ``mean``/``var``.

    On a CUDA tensor, K9 (``bn_act_eval_fused``) writes the result over x
    and returns x, or raises on what it does not take (not float32, not
    contiguous, not 3-d); the caller asks ``eval_kernel_applies`` first.
    On a CPU tensor the plain twin ``bn_act_eval_plain`` (the same
    operations) returns a new tensor.  ``bn_act_eval.launches`` counts
    K9's launches."""
    if not x.is_cuda:
        return bn_act_eval_plain(x, conv_bias, mean, var, gamma, beta, eps,
                                 act)
    mul = torch.rsqrt(var + eps) * gamma.to(mean.dtype)
    bias = torch.zeros_like(mean) if conv_bias is None else conv_bias
    return bn_act_eval_fused(x, bias, mean, mul, beta, act)


bn_act_eval.launches = 0


class _FusedBNAct(torch.autograd.Function):
    """K2 forward, K3 backward; the saved residuals are x, gamma, beta,
    mean, var (``ocm_tpu/ops/bn.py:214``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act, cluster):
        x = x.contiguous()
        out, mean, var = bn_act_fwd(x, gamma, beta, eps, act, cluster)
        ctx.save_for_backward(x, gamma, beta, mean, var)
        ctx.eps, ctx.act, ctx.cluster = eps, act, cluster
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, gamma, beta, mean, var = ctx.saved_tensors
        dx, dgamma, dbeta = bn_act_bwd(x, gamma, beta, mean, var,
                                       dout.contiguous(), ctx.eps, ctx.act,
                                       ctx.cluster)
        return dx, dgamma, dbeta, None, None, None


def fused_bn_act(x, gamma, beta, eps: float = 1e-5, act: str = "elu",
                 cluster=None):
    """Training-mode BatchNorm + activation of x (B, C, ...), one kernel
    each direction on the card.

    Returns ``(out, mean, var)``; mean/var are the batch statistics for the
    running-average update and carry no gradient (flax's convention: the
    running stats are state outside autodiff).  ``cluster`` is K2's and
    K3's blocks a channel (see ``bn_act_fwd``).
    """
    return _FusedBNAct.apply(x, gamma, beta, eps, act, cluster)


class _CrossReplicaBNAct(torch.autograd.Function):
    """BatchNorm + activation on batch statistics averaged over ranks: the
    forward all-reduces (mean, mean square), the backward their cotangents
    (the transpose of the average); fast variance clamped at 0."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act, pmean):
        f = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(f)
        dims = _stat_dims(x)
        mean, mean2 = pmean(torch.stack([xf.mean(dims),
                                         (xf * xf).mean(dims)]))
        raw = mean2 - mean * mean
        var = raw.clamp_min(0.0)
        ctx.save_for_backward(x, gamma, beta, mean, var, raw > 0)
        ctx.eps, ctx.act, ctx.pmean = eps, act, pmean
        ctx.mark_non_differentiable(mean, var)
        return bn_act_normalize(x, mean, var, gamma, beta, eps, act), mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, gamma, beta, mean, var, positive = ctx.saved_tensors
        f = mean.dtype
        rstd = torch.rsqrt(var + ctx.eps)
        xm = x.to(f) - _per_channel(mean, x)
        xhat = xm * _per_channel(rstd, x)
        y = xhat * _per_channel(gamma.to(f), x) + _per_channel(beta.to(f), x)
        dy = dout.to(f) * act_grad(y, ctx.act)
        dims = _stat_dims(x)
        dbeta = dy.sum(dims)
        dgamma = (dy * xhat).sum(dims)
        direct = dy * _per_channel(gamma.to(f) * rstd, x)
        # var = mean2 - mean^2 (where positive): d/dmean2 = 1, d/dmean = -2 mean
        dvar = torch.where(positive, (dy * xm).sum(dims) * gamma.to(f)
                           * (-0.5) * rstd ** 3, 0.0)
        dmean = -direct.sum(dims) - 2.0 * mean * dvar
        dmean_l, dmean2_l = ctx.pmean(torch.stack([dmean, dvar]))
        inv_n = 1.0 / (x.numel() // x.shape[1])
        dx = (direct + _per_channel(dmean_l * inv_n, x)
              + x.to(f) * _per_channel(2.0 * dmean2_l * inv_n, x))
        return (dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
                None, None, None)


def cross_replica_bn_act(x, gamma, beta, eps: float, act: str, pmean):
    """Training-mode BatchNorm + activation of x (B, C, ...) whose batch
    statistics are ``pmean`` (a callable averaging a (2, C) tensor over
    the data-parallel ranks) of each rank's mean and mean square.  Returns
    ``(out, mean, var)`` as ``fused_bn_act`` does."""
    return _CrossReplicaBNAct.apply(x, gamma, beta, eps, act, pmean)
