"""Hand-written CUDA kernels and their plain PyTorch twins.

- ``t2q_scores_multiclass`` is the port of the TPU kernel
  ``t2_q_scores_pallas`` (``ocm_tpu/ops/kernels.py:45``) in its
  multi-class form: T^2 and Q of every spectrum against C SIMCA models,
  centering directly (``x - m_c``) in one read of the spectra
  (``ocm_tpu_torch/csrc/t2q_scores.cu``), for f32 spectra and for bf16
  ones (the serving scorer's half-width residuals, widened as staged).
- ``int8_tile_sum`` (K7) and ``int8_gemm_s32`` (K8) are the ports of the
  int8 probe kernels ``make_read`` and ``make_gemm``
  (``scripts/probe_pallas_int8.py:70,84``): per-tile int32 sums of an int8
  array, and the exact s8 x s8 -> s32 product, written out or reduced to
  per-tile column sums in the kernel, on the tensor cores.  K8 is also the
  product of the int8 scoring op
  (``ops.linalg.t2_q_scores_multiclass_int8``)
  (``ocm_tpu_torch/csrc/int8.cu``).
- ``reparam_kl`` is the port of ``reparam_loss_pallas`` with explicit
  noise (``ocm_tpu/ops/kernels.py:110``): ``z = mu + eps * exp(lv / 2)``
  and the per-sample KL (``ocm_tpu_torch/csrc/reparam_kl.cu``).
  ``fused_reparam_kl`` (``ocm_tpu/ops/kernels.py:192``) wraps it in a
  ``torch.autograd.Function`` whose backward, the analytic VJP, is the
  kernel ``reparam_kl_bwd`` (the same source).
- ``reparam_kl_sample`` is the port of ``reparam_loss_pallas`` with
  ``eps=None`` (``ocm_tpu/ops/kernels.py:160-183``): the same function
  with the noise drawn in the kernel, Philox4x32-10 bits through the TPU
  kernel's Box-Muller (``ocm_tpu_torch/csrc/reparam_sample.cu``).  Its
  plain twin (``philox4x32_plain``, ``philox_normal_plain``) reproduces the
  kernel's bits in torch integer ops, so the twin is the same function,
  not only the same distribution.
- K4, K6's backward and K5 run one row a group of lanes by
  ``reparam_plan``, each launched as a programmatic dependent of the
  kernel before it (``csrc/common.cuh`` ``launch_dependent``); ``noop``
  launches the empty kernel whose device time is the card's launch floor,
  the yardstick of these launch-bound kernels.

Each CUDA source says what bounds its kernel on the card and how the
design answers that.  On a CPU tensor a wrapper computes its plain twin
(``*_plain``); on a CUDA tensor it launches the kernel or raises, and never
falls back.  ``<wrapper>.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import functools
import math
import operator
from typing import NamedTuple

import torch

from ocm_tpu_torch.ops import _build

_INT_MAX = 2 ** 31 - 1

# K1's launch (csrc/t2q_scores.cu): spectra a warp's unit (two a lane),
# columns of x a pipelined chunk (a row of it padded by 4 values), the
# most warps a CTA and the fewest that keep the models resident, the ring's
# stages, the sums a spectrum holds in a pass, loading rows a task
K1_UNIT, K1_CHUNK, K1_CHUNK_PAD = 64, 16, 4
K1_MAX_WARPS, K1_RESIDENT_WARPS, K1_STAGES = 12, 8, (2, 3, 4)
K1_MAX_ACC, K1_MAX_KB = 36, 32


class K1Plan(NamedTuple):
    """How K1 runs a call: one CTA an SM (``ctas``, persistent over units
    of 64 spectra) of ``warps`` warps, each streaming its x through a ring
    of ``stages`` chunks; the models of every class resident in shared
    memory (``resident``), or staged ``window`` columns at a time; invcov
    in shared memory or read from device memory; ``smem_bytes`` in all."""
    resident: bool
    warps: int
    stages: int
    ctas: int
    window: int
    icov_shared: bool
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def k1_plan(n: int, length: int, c: int, k: int, x_bytes: int, sms: int,
            smem_max: int) -> K1Plan:
    """K1's launch for x (n, length) of ``x_bytes`` an element (4 f32, 2
    bf16) against c models of k loadings, on a card of ``sms`` SMs whose
    blocks may opt in to ``smem_max`` bytes of shared memory.

    Warps: enough for the units (64 spectra) of one wave over ``sms`` CTAs,
    at most 12.  Resident where every class's model (KB + 1 rows of L
    rounded up to 16, a task) fits beside at least 8 (or all) warps' rings
    of 2 stages, with the most stages (up to 4) that fit; else staged, 2
    stages, with the widest window of columns that fits.  Raises if even
    one warp's ring and a 16-column window do not fit.  Cached: a pure
    function of its arguments, called at every launch."""
    if min(n, length, c, k, sms) < 1:
        raise ValueError(f"k1_plan: empty shape n={n} L={length} C={c} "
                         f"k={k} or sms={sms}")
    kb = min(k, K1_MAX_KB)
    tpc = -(-k // kb)
    per_pass = max(1, K1_MAX_ACC // (kb + 1))
    ntasks = c * tpc
    lp = -(-length // K1_CHUNK) * K1_CHUNK
    units = -(-n // K1_UNIT)
    ctas = min(sms, units)
    warps = min(K1_MAX_WARPS, -(-units // ctas))
    icov = -(-(4 * c * k * k) // 16) * 16
    icov_shared = icov <= smem_max // 4
    fixed = icov if icov_shared else 0
    ring = K1_UNIT * (K1_CHUNK + K1_CHUNK_PAD) * x_bytes
    res = K1_UNIT * k * 4 if tpc > 1 else 0

    def total(tasks, window, w, stages):
        return tasks * (kb + 1) * window * 4 + fixed + w * (stages * ring
                                                            + res)

    for w in range(warps, min(warps, K1_RESIDENT_WARPS) - 1, -1):
        for stages in reversed(K1_STAGES):
            smem = total(ntasks, lp, w, stages)
            if smem <= smem_max:
                return K1Plan(True, w, stages, ctas, lp, icov_shared, smem)
    stages, tasks = K1_STAGES[0], min(per_pass, ntasks)
    for w in range(warps, 0, -1):
        room = smem_max - total(0, 0, w, stages)
        window = min(lp, room // (4 * tasks * (kb + 1)) // K1_CHUNK
                     * K1_CHUNK)
        if window >= K1_CHUNK:
            return K1Plan(False, w, stages, ctas, window, icov_shared,
                          total(tasks, window, w, stages))
    raise ValueError(f"k1_plan: C={c} k={k} L={length} does not fit in "
                     f"{smem_max} bytes of shared memory")


def check_cuda_tensors(what, tensors, dtype=torch.float32):
    """Raise unless every tensor of ``tensors`` ({name: (tensor, ndim)})
    is a contiguous CUDA tensor of that rank and ``dtype`` on one device."""
    device = next(iter(tensors.values()))[0].device
    if device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {device}")
    for name, (a, ndim) in tensors.items():
        if a.device != device:
            raise ValueError(f"{what}: {name} is on {a.device}, not {device}")
        if a.dtype != dtype:
            raise TypeError(f"{what}: the CUDA kernel takes {dtype} tensors; "
                            f"{name} is {a.dtype}")
        if a.dim() != ndim or not a.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {ndim}-d "
                             f"tensor, got shape {tuple(a.shape)}")
        if a.numel() > _INT_MAX:
            raise ValueError(f"{what}: {name} exceeds int32 indexing")


def stream_of(x) -> int:
    """The current CUDA stream of ``x``'s device, as a pointer."""
    return torch.cuda.current_stream(x.device).cuda_stream


def noop(device):
    """One launch of the library's empty kernel (``ocm_noop``, one block of
    32 threads) on ``device``'s current stream: its device time is the
    card's launch floor.  ``launches`` counts it."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"noop launches on a CUDA device, not {device}")
    with torch.cuda.device(device):
        err = _build.library().ocm_noop(
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "noop")
    noop.launches += 1


noop.launches = 0


def t2q_scores_multiclass_plain(x, means, components, invcovs):
    """T^2 and Q of ``x`` (N, L) against C models, in plain PyTorch.

    means (C, L), components (C, k, L), invcovs (C, k, k); f32 or f64.
    A bf16 ``x`` is widened to the means' dtype.  Returns t2 (C, N) and
    q (C, N).
    """
    xc = x.to(means.dtype)[None, :, :] - means[:, None, :]  # (C, N, L)
    t = xc @ components.mT                                 # (C, N, k)
    t2 = ((t @ invcovs) * t).sum(-1)
    q = ((xc * xc).sum(-1) - (t * t).sum(-1)).clamp_min(0.0)
    return t2, q


def t2q_scores_multiclass(x, means, components, invcovs):
    """Fused T^2/Q scoring of ``x`` (N, L) against C models at once.

    CPU tensors: the plain twin.  CUDA tensors (contiguous; ``x`` float32
    or bfloat16, the rest float32): the hand-written kernel on the current
    stream, its f32 or its bf16-input instantiation, one launch by
    ``k1_plan``; ``launches`` and ``launches_bf16`` count them.  Returns
    t2, q, each (C, N), f32.
    """
    if x.device.type == "cpu":
        return t2q_scores_multiclass_plain(x, means, components, invcovs)
    bf16 = x.dtype == torch.bfloat16
    check_cuda_tensors("t2q_scores_multiclass", {"x": (x, 2)},
                       torch.bfloat16 if bf16 else torch.float32)
    check_cuda_tensors("t2q_scores_multiclass", {
        "means": (means, 2), "components": (components, 3),
        "invcovs": (invcovs, 3)})
    if means.device != x.device:
        raise ValueError(f"t2q_scores_multiclass: means are on "
                         f"{means.device}, x on {x.device}")
    n, length = x.shape
    c, k, length_p = components.shape
    if (means.shape != (c, length) or length_p != length
            or invcovs.shape != (c, k, k) or k < 1):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, means {tuple(means.shape)}, "
            f"components {tuple(components.shape)}, invcovs "
            f"{tuple(invcovs.shape)}")
    t2 = torch.empty((c, n), dtype=torch.float32, device=x.device)
    q = torch.empty_like(t2)
    if n == 0 or c == 0:
        return t2, q
    with torch.cuda.device(x.device):
        lib = _build.library()
        plan = k1_plan(n, length, c, k, x.element_size(),
                       *_build.device_limits(x.device.index))
        entry = (lib.t2q_scores_multiclass_bf16 if bf16
                 else lib.t2q_scores_multiclass_f32)
        err = entry(x.data_ptr(), means.data_ptr(), components.data_ptr(),
                    invcovs.data_ptr(), t2.data_ptr(), q.data_ptr(),
                    n, length, c, k, plan.warps, plan.stages, plan.window,
                    plan.resident, plan.icov_shared, plan.ctas,
                    plan.smem_bytes, stream_of(x))
    _build.check(err, "t2q_scores_multiclass")
    if bf16:
        t2q_scores_multiclass.launches_bf16 += 1
    else:
        t2q_scores_multiclass.launches += 1
    return t2, q


t2q_scores_multiclass.launches = 0
t2q_scores_multiclass.launches_bf16 = 0


def int8_tile_sum_plain(xq, tile: int):
    """The int32 sum of every ``tile`` consecutive rows of int8 ``xq``
    (N, L), N a multiple of ``tile``: (N // tile,) int32.  This is also
    the one PyTorch call that computes it."""
    return xq.view(xq.shape[0] // tile, -1).sum(1, dtype=torch.int32)


def _check_tile(what, n: int, tile: int):
    if tile < 1 or n % tile:
        raise ValueError(f"{what}: tile={tile} must be >= 1 and divide the "
                         f"{n} rows")


def int8_tile_sum(xq, tile: int):
    """Kernel K7: per-tile int32 sums of int8 ``xq`` (N, L), (N // tile,).

    CPU tensors: the plain twin.  CUDA tensors (int8, contiguous): the
    hand-written kernel on the current stream (``launches`` counts it).
    """
    n = xq.shape[0]
    _check_tile("int8_tile_sum", n, tile)
    if xq.device.type == "cpu":
        return int8_tile_sum_plain(xq, tile)
    check_cuda_tensors("int8_tile_sum", {"xq": (xq, 2)}, torch.int8)
    out = torch.zeros((n // tile,), dtype=torch.int32, device=xq.device)
    if xq.numel() == 0:
        return out
    with torch.cuda.device(xq.device):
        err = _build.library().int8_tile_sum(
            xq.data_ptr(), out.data_ptr(), n, xq.shape[1], tile,
            stream_of(xq))
    _build.check(err, "int8_tile_sum")
    int8_tile_sum.launches += 1
    return out


int8_tile_sum.launches = 0


def int8_gemm_s32_plain(xq, w, tile=None):
    """``xq @ w.T`` of int8 ``xq`` (N, L) and ``w`` (M, L) in int32, exact:
    the product in float64 of the int8 values (every partial sum is an
    integer below 2^53), cast to int32.  With ``tile``, the column sums of
    every ``tile`` rows, (N // tile, M), wrapped mod 2^32 like int32 sums.
    In float64 because the card has no integer matmul in PyTorch."""
    g = (xq.to(torch.float64) @ w.to(torch.float64).T).to(torch.int64)
    if tile is not None:
        g = g.view(xq.shape[0] // tile, tile, -1).sum(1)
    return g.to(torch.int32)


def int8_gemm_s32(xq, w, tile=None):
    """Kernel K8: the exact s8 x s8 -> s32 product ``xq @ w.T`` of ``xq``
    (N, L) and ``w`` (M, L), (N, M) int32; with ``tile`` its column sums
    over each ``tile`` rows, (N // tile, M), reduced in the kernel.

    CPU tensors: the plain twin.  CUDA tensors (int8, contiguous): one
    launch on the current stream (``launches`` counts it) of the
    tensor-core kernel (``mma.sync`` s8, w resident in shared memory, x
    streamed by bulk copies), or, for rows not 4-byte aligned, an x not
    16-byte aligned or rows too long for shared memory, of the ``__dp4a``
    kernel.
    """
    n, length = xq.shape
    m = w.shape[0]
    if w.dim() != 2 or w.shape[1] != length:
        raise ValueError(f"int8_gemm_s32: w must be (M, {length}), got "
                         f"{tuple(w.shape)}")
    if tile is not None:
        _check_tile("int8_gemm_s32", n, tile)
    if xq.device.type == "cpu":
        return int8_gemm_s32_plain(xq, w, tile)
    check_cuda_tensors("int8_gemm_s32", {"xq": (xq, 2), "w": (w, 2)},
                       torch.int8)
    rows = n if tile is None else n // tile
    out = (torch.empty if tile is None else torch.zeros)(
        (rows, m), dtype=torch.int32, device=xq.device)
    if out.numel() == 0:
        return out
    if length == 0:
        return out.zero_()
    with torch.cuda.device(xq.device):
        err = _build.library().int8_gemm_s32(
            xq.data_ptr(), w.data_ptr(), out.data_ptr(), n, length, m,
            tile or 0, stream_of(xq))
    _build.check(err, "int8_gemm_s32")
    int8_gemm_s32.launches += 1
    return out


int8_gemm_s32.launches = 0


# K4, K6's backward and K5: threads a block (csrc/common.cuh kRowThreads)
REPARAM_THREADS = 256


class ReparamPlan(NamedTuple):
    """How K4, K6's backward and K5 run a call of N rows of k: ``lanes``
    lanes a row (a power of two <= 32, so a warp holds 32 // lanes rows),
    ``rows`` rows a block of 256 threads, ``blocks`` blocks, and ``vec``
    bytes a lane moves a tensor at a time (16, 8 or 4)."""
    lanes: int
    rows: int
    blocks: int
    vec: int


@functools.lru_cache(maxsize=256)
def reparam_plan(n: int, k: int, align: int = 16,
                 sampled: bool = False) -> ReparamPlan:
    """The row-group launch of (n, k) f32 rows whose tensors' bases (and
    row strides, in bytes) are all ``align``-byte aligned (16, 8 or 4).

    K4 and K6's backward (``sampled`` False): 16-byte vectors where k % 4
    == 0 and ``align`` is 16, 8-byte where k is even and ``align`` >= 8,
    else scalars; a row's lanes step over its k / (vec / 4) vectors.  K5
    (``sampled``): a lane step is an element pair, drawn by one Philox
    call, and a row touches (k + 1) // 2 of them (at odd k its first or
    last pair straddles into the next row); 8-byte accesses where k is
    even and ``align`` >= 8, else scalars.  Lanes: the smallest power of
    two >= the steps, at most 32; each lane takes steps lane, lane +
    lanes, ...  The C entry points recompute the plan from their own
    pointers and refuse one that differs.  Cached: a pure function of its
    arguments, called at every launch."""
    if min(n, k) < 1:
        raise ValueError(f"reparam_plan: empty shape n={n} k={k}")
    if sampled:
        vec = 8 if k % 2 == 0 and align >= 8 else 4
        steps = (k + 1) // 2
    else:
        vec = (16 if k % 4 == 0 and align >= 16
               else 8 if k % 2 == 0 and align >= 8 else 4)
        steps = k // (vec // 4)
    lanes = min(32, 1 << (steps - 1).bit_length())
    rows = REPARAM_THREADS // lanes
    return ReparamPlan(lanes, rows, -(-n // rows), vec)


def _alignment(*addresses: int) -> int:
    """16, 8 or 4: the largest of them that divides every address."""
    bits = functools.reduce(operator.or_, addresses)
    return 16 if bits % 16 == 0 else 8 if bits % 8 == 0 else 4


def _check_latent(what, mu, others):
    """``mu`` and ``others`` ({name: tensor}) are (N, k) f32 CUDA tensors,
    contiguous, on one device."""
    check_cuda_tensors(what, {"mu": (mu, 2),
                              **{k: (v, 2) for k, v in others.items()}})
    for name, a in others.items():
        if a.shape != mu.shape:
            raise ValueError(f"shape mismatch: mu {tuple(mu.shape)}, {name} "
                             f"{tuple(a.shape)}")


def reparam_kl_plain(mu, logvar, eps):
    """``z = mu + eps * exp(logvar / 2)`` and the per-sample
    ``kl = -1/2 * sum_j (1 + lv - mu^2 - e^lv)``, in plain PyTorch."""
    z = mu + eps * torch.exp(0.5 * logvar)
    kl = -0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar)).sum(-1)
    return z, kl


def reparam_kl(mu, logvar, eps):
    """Reparameterize and per-sample KL of (N, k) ``mu``, ``logvar`` with
    the given noise ``eps``; returns z (N, k) and kl (N,).

    CPU tensors: the plain twin.  CUDA tensors (float32, contiguous): the
    hand-written kernel K4 on the current stream, one launch by
    ``reparam_plan``.
    """
    if mu.device.type == "cpu":
        return reparam_kl_plain(mu, logvar, eps)
    _check_latent("reparam_kl", mu, {"logvar": logvar, "eps": eps})
    n, k = mu.shape
    z = torch.empty_like(mu)
    kl = torch.empty((n,), dtype=torch.float32, device=mu.device)
    if n == 0 or k == 0:
        return z, kl.zero_()
    plan = reparam_plan(n, k, _alignment(mu.data_ptr(), logvar.data_ptr(),
                                         eps.data_ptr(), z.data_ptr()))
    with torch.cuda.device(mu.device):
        err = _build.library().reparam_kl_f32(
            mu.data_ptr(), logvar.data_ptr(), eps.data_ptr(), z.data_ptr(),
            kl.data_ptr(), n, k, *plan, stream_of(mu))
    _build.check(err, "reparam_kl")
    reparam_kl.launches += 1
    return z, kl


reparam_kl.launches = 0


def reparam_kl_bwd_plain(mu, logvar, eps, dz, dkl):
    """The VJP of ``reparam_kl`` (``ocm_tpu/ops/kernels.py:212-218``), in
    plain PyTorch: dmu = dz + dkl * mu, dlv = dz * eps * e^(lv/2) / 2 -
    dkl * (1 - e^lv) / 2, for dz (N, k) and dkl (N,)."""
    dkl = dkl[:, None]
    dmu = dz + dkl * mu
    dlv = (dz * 0.5 * eps * torch.exp(0.5 * logvar)
           - dkl * 0.5 * (1.0 - torch.exp(logvar)))
    return dmu, dlv


def reparam_kl_bwd(mu, logvar, eps, dz, dkl):
    """K6's backward: (dmu, dlv) of ``reparam_kl`` at (mu, logvar, eps) for
    the gradients dz (N, k) of z and dkl (N,) of the per-sample KL.

    CPU tensors: the plain twin.  CUDA tensors (float32; mu, logvar, eps
    contiguous; dz and dkl with any non-negative strides, so the stride-0
    expand that ``kl.mean()``'s gradient arrives as is read in place): the
    hand-written kernel on the current stream, one launch by
    ``reparam_plan``; ``launches`` counts it.
    """
    if mu.device.type == "cpu":
        return reparam_kl_bwd_plain(mu, logvar, eps, dz, dkl)
    _check_latent("reparam_kl_bwd", mu, {"logvar": logvar, "eps": eps})
    n, k = mu.shape
    for name, a, shape in (("dz", dz, (n, k)), ("dkl", dkl, (n,))):
        if a.device != mu.device or a.dtype != torch.float32:
            raise TypeError(f"reparam_kl_bwd: {name} must be float32 on "
                            f"{mu.device}, got {a.dtype} on {a.device}")
        if tuple(a.shape) != shape or min(a.stride(), default=0) < 0:
            raise ValueError(f"reparam_kl_bwd: {name} must be {shape} with "
                             f"non-negative strides, got {tuple(a.shape)} "
                             f"strides {a.stride()}")
    dmu, dlv = torch.empty_like(mu), torch.empty_like(mu)
    if n == 0 or k == 0:
        return dmu, dlv
    rs, cs = dz.stride()
    if max(rs, cs, dkl.stride(0)) * max(n, k) > _INT_MAX:
        raise ValueError("reparam_kl_bwd: dz or dkl exceeds int32 indexing")
    align = 4 if cs != 1 else _alignment(
        mu.data_ptr(), logvar.data_ptr(), eps.data_ptr(), dz.data_ptr(),
        dmu.data_ptr(), dlv.data_ptr(), 4 * rs)
    plan = reparam_plan(n, k, align)
    with torch.cuda.device(mu.device):
        err = _build.library().reparam_kl_bwd_f32(
            mu.data_ptr(), logvar.data_ptr(), eps.data_ptr(), dz.data_ptr(),
            dkl.data_ptr(), dmu.data_ptr(), dlv.data_ptr(), n, k, rs, cs,
            dkl.stride(0), *plan, stream_of(mu))
    _build.check(err, "reparam_kl_bwd")
    reparam_kl_bwd.launches += 1
    return dmu, dlv


reparam_kl_bwd.launches = 0


class _FusedReparamKL(torch.autograd.Function):
    """Forward: ``reparam_kl`` (K4).  Backward: ``reparam_kl_bwd``
    (``ocm_tpu/ops/kernels.py:212-218``), one kernel on the card where
    JAX fuses the VJP into one XLA pass; eps gets no gradient."""

    @staticmethod
    def forward(ctx, mu, logvar, eps):
        z, kl = reparam_kl(mu, logvar, eps)
        ctx.save_for_backward(mu, logvar, eps)
        return z, kl

    @staticmethod
    def backward(ctx, dz, dkl):
        dmu, dlv = reparam_kl_bwd(*ctx.saved_tensors, dz, dkl)
        return dmu, dlv, None


def fused_reparam_kl(mu, logvar, eps):
    """Differentiable ``reparam_kl``: returns (z, kl_per_sample)."""
    return _FusedReparamKL.apply(mu, logvar, eps)


# Philox4x32-10 (Random123): round multipliers and key bumps
_PHILOX_MUL = (0xD2511F53, 0xCD9E8D57)
_PHILOX_BUMP = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF
_U64 = 2 ** 64


def _mulhilo(a, m: int):
    """(high, low) 32-bit words of ``a * m`` for int64 ``a`` in [0, 2^32)
    and a 32-bit constant ``m``, with no int64 overflow: m is split into
    16-bit halves, so every partial product stays below 2^48."""
    t_lo, t_hi = a * (m & 0xFFFF), a * (m >> 16)
    return ((t_hi + (t_lo >> 16)) >> 16,
            (((t_hi & 0xFFFF) << 16) + t_lo) & _MASK32)


def philox4x32_plain(counter, key):
    """Philox4x32-10 of ``counter`` (..., 4) int64 words in [0, 2^32) under
    ``key`` = (k0, k1), Python ints; returns (..., 4) int64 words."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_MUL[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_MUL[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_BUMP[0]) & _MASK32
        k1 = (k1 + _PHILOX_BUMP[1]) & _MASK32
    return torch.stack((c0, c1, c2, c3), -1)


def _check_seed(seed, offset):
    seed, offset = int(seed), int(offset)
    if not (0 <= seed < _U64 and 0 <= offset < _U64):
        raise ValueError(f"seed and offset are unsigned 64-bit integers; got "
                         f"seed={seed}, offset={offset}")
    return seed, offset


def philox_normal_plain(n: int, k: int, seed: int, offset: int = 0,
                        dtype=torch.float32, device="cpu"):
    """The (n, k) standard normals kernel K5 draws for ``(seed, offset)``:
    Philox4x32-10 with key ``seed`` and counter (element-pair index,
    offset); words (w0, w1) of pair p make element 2p, (w2, w3) element
    2p + 1 (elements in row-major order), each through the TPU kernel's
    Box-Muller (``ocm_tpu/ops/kernels.py:169-174``)."""
    seed, offset = _check_seed(seed, offset)
    pairs = torch.arange((n * k + 1) // 2, dtype=torch.int64, device=device)
    counter = torch.stack((pairs & _MASK32, pairs >> 32,
                           torch.full_like(pairs, offset & _MASK32),
                           torch.full_like(pairs, offset >> 32)), -1)
    w = philox4x32_plain(counter, (seed & _MASK32, seed >> 32))
    b1 = w[:, 0::2].reshape(-1)[:n * k]
    b2 = w[:, 1::2].reshape(-1)[:n * k]
    u1 = (b1 >> 8).to(dtype) * 2.0 ** -24 + 1e-7
    u2 = (b2 >> 8).to(dtype) * 2.0 ** -24
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return eps.view(n, k)


def reparam_kl_sample_plain(mu, logvar, seed: int, offset: int = 0):
    """``reparam_kl_plain`` with the noise of ``philox_normal_plain``;
    returns (z, kl, eps)."""
    n, k = mu.shape
    eps = philox_normal_plain(n, k, seed, offset, mu.dtype, mu.device)
    return (*reparam_kl_plain(mu, logvar, eps), eps)


def reparam_kl_sample(mu, logvar, seed: int, offset: int = 0,
                      return_eps: bool = False):
    """Reparameterize and per-sample KL of (N, k) ``mu``, ``logvar`` with
    standard-normal noise drawn in the kernel from ``(seed, offset)``
    (unsigned 64-bit); returns z (N, k), kl (N,) and, with ``return_eps``,
    the noise.

    CPU tensors: the plain twin.  CUDA tensors (float32, contiguous): the
    hand-written kernel K5 on the current stream, one launch by
    ``reparam_plan(sampled=True)``.  Inference only: the TPU
    kernel's ``eps=None`` branch has no VJP, so this raises when grad is
    enabled and an input requires it.
    """
    if torch.is_grad_enabled() and (mu.requires_grad or logvar.requires_grad):
        raise RuntimeError(
            "reparam_kl_sample draws its noise in the kernel and has no "
            "gradient; call it under torch.no_grad() or "
            "torch.inference_mode(), or pass eps to fused_reparam_kl")
    seed, offset = _check_seed(seed, offset)
    if mu.device.type == "cpu":
        z, kl, eps = reparam_kl_sample_plain(mu, logvar, seed, offset)
        return (z, kl, eps) if return_eps else (z, kl)
    _check_latent("reparam_kl_sample", mu, {"logvar": logvar})
    n, k = mu.shape
    z = torch.empty_like(mu)
    kl = torch.empty((n,), dtype=torch.float32, device=mu.device)
    eps = torch.empty_like(mu) if return_eps else None
    if n and not k:
        kl.zero_()
    if n and k:
        plan = reparam_plan(n, k, _alignment(
            mu.data_ptr(), logvar.data_ptr(), z.data_ptr(),
            0 if eps is None else eps.data_ptr()), sampled=True)
        with torch.cuda.device(mu.device):
            err = _build.library().reparam_kl_sample_f32(
                mu.data_ptr(), logvar.data_ptr(), z.data_ptr(), kl.data_ptr(),
                None if eps is None else eps.data_ptr(), n, k, seed, offset,
                *plan, stream_of(mu))
        _build.check(err, "reparam_kl_sample")
        reparam_kl_sample.launches += 1
    return (z, kl, eps) if return_eps else (z, kl)


reparam_kl_sample.launches = 0
