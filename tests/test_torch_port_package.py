"""Package rules of the port: it imports neither JAX nor ``ocm_tpu``, it
never runs quietly on the CPU when CUDA was (implicitly) asked for, and
its kernel wrappers count only real kernel launches.  The kernel-vs-twin
tests need a CUDA card and skip without one."""

import ast
import itertools
import os
import pathlib
import subprocess
import sys

import math

import numpy as np
import pytest
import torch

from ocm_tpu_torch.models import simca as TS
from ocm_tpu_torch.models import trainer as TT
from ocm_tpu_torch.models import vae as TV
from ocm_tpu_torch.models import vae_decision, vaesimca
from ocm_tpu_torch.ops import _build, bn, kernels
from ocm_tpu_torch.stats import metrics

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ocm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_no_jax():
    code = ("import sys, ocm_tpu_torch, ocm_tpu_torch.models.simca, "
            "ocm_tpu_torch.ops.kernels, ocm_tpu_torch.ops._build, "
            "ocm_tpu_torch.ops.bn, ocm_tpu_torch.models.vae, "
            "ocm_tpu_torch.models.bundle, ocm_tpu_torch.models.trainer, "
            "ocm_tpu_torch.models.vae_decision, ocm_tpu_torch.models.vaesimca, "
            "ocm_tpu_torch.serving, ocm_tpu_torch.stats.qhf, "
            "ocm_tpu_torch.stats.metrics, ocm_tpu_torch.models.streaming, "
            "ocm_tpu_torch.ops.preprocess, ocm_tpu_torch.probes.int8, "
            "ocm_tpu_torch.models.cv, ocm_tpu_torch.utils.msgpack_io, "
            "ocm_tpu_torch.utils.native, ocm_tpu_torch.utils.synthetic, "
            "ocm_tpu_torch.utils.io, ocm_tpu_torch.utils.outliers, "
            "ocm_tpu_torch.utils.splits, ocm_tpu_torch.models.plsda, "
            "ocm_tpu_torch.utils.checkpoint, ocm_tpu_torch.utils.profiling, "
            "ocm_tpu_torch.utils.report, ocm_tpu_torch.models.stacked, "
            "ocm_tpu_torch.utils.sweep, ocm_tpu_torch.utils.tpe, "
            "ocm_tpu_torch.cli, ocm_tpu_torch.server, ocm_tpu_torch.config, "
            "ocm_tpu_torch.models.torch_import, "
            "ocm_tpu_torch.models.torch_export, "
            "ocm_tpu_torch.parallel.mesh, ocm_tpu_torch.parallel.simca_dist, "
            "ocm_tpu_torch.parallel.sweep_dist, "
            "ocm_tpu_torch.parallel.train_dist; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ocm_tpu', 'ml_dtypes', 'flax', 'msgpack', 'orbax', "
            "'h5py', 'matplotlib', 'scipy', 'sklearn')]; "
            "print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["ocm_tpu_torch.cli",
                                    "ocm_tpu_torch.server",
                                    "ocm_tpu_torch.parallel"])
def test_front_doors_load_no_heavy_dependency(module):
    """The CLI, the server and the parallel package load scipy, h5py and
    matplotlib only in the commands that use them, and never sklearn (the
    card's machine has neither sklearn nor h5py)."""
    code = (f"import sys, {module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('sklearn', 'scipy', 'h5py', 'matplotlib', 'jax', 'ocm_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sklearn_api_imports_without_sklearn():
    """Where scikit-learn is missing (the card's machine), the facade
    imports (stub bases) and every ``fit`` raises ImportError."""
    code = ("import sys; sys.modules['sklearn'] = None\n"
            "import numpy as np\n"
            "from ocm_tpu_torch import sklearn_api as T\n"
            "assert not T._HAVE_SKLEARN\n"
            "for est in (T.SIMCAOneClass(device='cpu'), "
            "T.SIMCAClassifier(device='cpu'), "
            "T.VAESIMCAOneClass(device='cpu')):\n"
            "    try:\n"
            "        est.fit(np.zeros((8, 4)), np.arange(8) % 2)\n"
            "    except ImportError as e:\n"
            "        assert 'scikit-learn' in str(e), e\n"
            "    else:\n"
            "        raise SystemExit('fit ran without sklearn')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "ocm_tpu",
                               "ml_dtypes", "msgpack"), (path, name)


def test_native_core_is_the_ports_own_copy():
    """The port builds its own ``csrc/ccl.cpp`` into its own ``_build/``,
    never the JAX package's ``native/ccl.cpp`` or its cache."""
    from ocm_tpu_torch.utils import native

    assert native.SOURCE == ROOT / "ocm_tpu_torch" / "csrc" / "ccl.cpp"
    assert native.BUILD_DIR == ROOT / "ocm_tpu_torch" / "_build"
    for path in PORT_FILES:
        text = path.read_text()
        assert "native/ccl.cpp" not in text, path
        assert ".cache/ocm_tpu" not in text, path


def test_numpy_input_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    x = np.random.default_rng(0).normal(size=(30, 12))
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.fit_simca(x, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.simca_model_from_numpy({})
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.train_vae(TV.ConvVAE1D(12, 2, conv_blocks=1, n_filters=4,
                                  hidden_fc=8), x, x[:4],
                     TT.TrainConfig(epochs=1), seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        vaesimca.vaesimca_model_from_numpy({})
    with pytest.raises(RuntimeError, match="CUDA"):
        vae_decision.compute_rec_error(x, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.roc_auc(x[:, 0] > 0, x[:, 1])


def test_cpu_wrapper_does_not_count_launches():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(20, 16)), dtype=torch.float32)
    means = torch.zeros(2, 16)
    comps = torch.linalg.qr(torch.randn(16, 3, generator=torch.Generator().manual_seed(0)))[0].mT
    comps = torch.stack([comps, comps]).contiguous()
    invcovs = torch.eye(3).expand(2, 3, 3).contiguous()
    before = kernels.t2q_scores_multiclass.launches
    t2, q = kernels.t2q_scores_multiclass(x, means, comps, invcovs)
    assert kernels.t2q_scores_multiclass.launches == before
    assert t2.shape == q.shape == (2, 20)


def test_cpu_vae_wrappers_do_not_count_launches():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 10, generator=gen)
    g, b = torch.ones(3), torch.zeros(3)
    mu, lv, eps = torch.randn(3, 5, 4, generator=gen)
    before = (bn.bn_act_fwd.launches, bn.bn_act_bwd.launches,
              kernels.reparam_kl.launches)
    out, mean, var = bn.bn_act_fwd(x, g, b)
    bn.bn_act_bwd(x, g, b, mean, var, torch.ones_like(x))
    kernels.reparam_kl(mu, lv, eps)
    assert (bn.bn_act_fwd.launches, bn.bn_act_bwd.launches,
            kernels.reparam_kl.launches) == before
    assert out.shape == x.shape and mean.shape == var.shape == (3,)


def test_cpu_fused_reparam_kl_counts_no_launch():
    gen = torch.Generator().manual_seed(0)
    mu, lv, eps = torch.randn(3, 6, 4, generator=gen)
    m, v = mu.clone().requires_grad_(), lv.clone().requires_grad_()
    before = (kernels.reparam_kl.launches, kernels.reparam_kl_bwd.launches)
    z, kl = kernels.fused_reparam_kl(m, v, eps)
    (z.sum() + kl.mean()).backward()
    assert (kernels.reparam_kl.launches,
            kernels.reparam_kl_bwd.launches) == before
    assert m.grad.shape == v.grad.shape == (6, 4)


def test_cpu_sample_wrapper_counts_no_launch_and_refuses_grad():
    gen = torch.Generator().manual_seed(0)
    mu, lv = torch.randn(2, 6, 3, generator=gen)
    before = kernels.reparam_kl_sample.launches
    z, kl = kernels.reparam_kl_sample(mu, lv, seed=5)
    assert kernels.reparam_kl_sample.launches == before
    assert z.shape == (6, 3) and kl.shape == (6,)
    m = mu.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        kernels.reparam_kl_sample(m, lv, seed=5)
    with torch.no_grad():
        torch.testing.assert_close(kernels.reparam_kl_sample(m, lv, 5)[0], z)
    with pytest.raises(ValueError, match="64-bit"):
        kernels.reparam_kl_sample(mu, lv, seed=-1)
    with pytest.raises(ValueError, match="exactly one"):
        TV.ConvVAE1D(12, 2, conv_blocks=1, n_filters=4, hidden_fc=8)(
            torch.zeros(2, 12))


def test_cpu_int8_wrappers_do_not_count_launches():
    gen = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (12, 10), dtype=torch.int8, generator=gen)
    before = (kernels.int8_tile_sum.launches, kernels.int8_gemm_s32.launches,
              kernels.t2q_scores_multiclass.launches_bf16)
    assert kernels.int8_tile_sum(xq, 4).shape == (3,)
    assert kernels.int8_gemm_s32(xq, xq[:5]).shape == (12, 5)
    assert kernels.int8_gemm_s32(xq, xq[:5], tile=3).shape == (4, 5)
    x = torch.randn(6, 10, generator=gen).to(torch.bfloat16)
    kernels.t2q_scores_multiclass(x, torch.zeros(1, 10), torch.eye(10)[None, :2],
                                  torch.eye(2)[None])
    assert (kernels.int8_tile_sum.launches, kernels.int8_gemm_s32.launches,
            kernels.t2q_scores_multiclass.launches_bf16) == before
    with pytest.raises(ValueError, match="divide"):
        kernels.int8_tile_sum(xq, 5)
    with pytest.raises(ValueError, match="divide"):
        kernels.int8_gemm_s32(xq, xq[:5], tile=0)
    with pytest.raises(ValueError, match="must be"):
        kernels.int8_gemm_s32(xq, xq[:5, :4])


def test_non_cpu_non_cuda_tensor_raises():
    xq = torch.zeros(4, 8, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.int8_tile_sum(xq, 2)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.int8_gemm_s32(xq, xq)
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.t2q_scores_multiclass(x, x[:1], x[None, :1], x[None, :1, :1])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.reparam_kl(x, x, x)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.reparam_kl_sample(x, x, 0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.reparam_kl_bwd(x, x, x, x, x[:, 0])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.noop("meta")
    x3, c = torch.zeros(2, 4, 8, device="meta"), torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bn.bn_act_fwd(x3, c, c)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bn.bn_act_bwd(x3, c, c, c, c, x3)


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


# (N, L, C, k, aligned): the bench's shapes cut in N, a ragged single
# class, models staged a pass at a time (C 5, k 12, L 2000), k > 32 (two
# tasks a class) with L not a multiple of 4, k = 1 (18 classes to a pass)
# with C 20, k = 33 (a one-row second task), x rows off 16-byte alignment
# (scalar staging although L is a multiple of 4), N below the CTA count, N
# off the 64-row unit, units over three rounds of every CTA's 12 warps,
# models staged in windows of L with warps that sit out a round, five
# passes of nine classes (C 40, k 3), and k > 32 with an invcov read from
# device memory (C 20, k 40)
KERNEL_CASES = [(4096, 500, 3, 10, True), (137, 96, 1, 8, True),
                (1000, 2000, 5, 12, True), (300, 203, 2, 40, True),
                (500, 64, 20, 1, True), (200, 100, 2, 33, True),
                (257, 96, 2, 5, False), (100, 500, 3, 10, True),
                (8191, 500, 3, 10, True), (202757, 64, 3, 10, True),
                (20000, 3000, 3, 12, True), (700, 96, 40, 3, True),
                (300, 100, 20, 40, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=str)
def test_kernel_matches_plain_twin(cuda, case):
    n, length, c, k, aligned = case
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = (torch.randn(n * length + 1, generator=gen) + 5.0).to(cuda)
    x = (x[:-1] if aligned else x[1:]).view(n, length)
    means = 5.0 + 0.1 * torch.randn(c, length, generator=gen)
    comps = torch.linalg.qr(torch.randn(c, length, k, generator=gen))[0].mT
    a = torch.randn(c, k, k, generator=gen)
    invcovs = a @ a.mT / k + torch.eye(k)
    args = [x] + [t.to(cuda, torch.float32).contiguous()
                  for t in (means, comps, invcovs)]
    assert (x.data_ptr() % 16 == 0) == aligned and x.is_contiguous()
    before = kernels.t2q_scores_multiclass.launches
    t2, q = kernels.t2q_scores_multiclass(*args)
    torch.cuda.synchronize()
    assert kernels.t2q_scores_multiclass.launches == before + 1
    t2_p, q_p = kernels.t2q_scores_multiclass_plain(*args)
    xc2 = ((args[0][None] - args[1][:, None]) ** 2).sum(-1)
    # rtol alone fails where T^2 ~ 0 (seen at k = 1): the scores carry f32
    # rounding of order eps ||x - m||, so the absolute error floor scales
    # with the typical T^2, not with the element's own
    torch.testing.assert_close(t2, t2_p, rtol=1e-4,
                               atol=1e-6 * t2_p.abs().mean().item())
    assert torch.all((q - q_p).abs() <= 1e-4 * xc2)


# an H100's SMs and the shared memory a block may opt in to
H100_LIMITS = (132, 232448)


@pytest.mark.parametrize("n,x_bytes", [(98304, 4), (65536, 4), (65536, 2),
                                       (98304, 2)], ids=str)
def test_k1_plan_is_resident_at_the_path_shapes(n, x_bytes):
    """The main path's scoring (98,304 x 500, C 3, k 10) and a serving
    chunk (65,536), f32 and bf16: every model resident, one CTA an SM,
    just enough warps for every unit of 64 spectra in one wave, 2-4
    stages, within the 227 KB a block may use."""
    plan = kernels.k1_plan(n, 500, 3, 10, x_bytes, *H100_LIMITS)
    assert plan.resident and plan.icov_shared
    units = -(-n // kernels.K1_UNIT)
    assert plan.ctas == 132 and plan.warps == -(-units // 132)
    assert 2 <= plan.stages <= 4
    assert plan.window == -(-500 // kernels.K1_CHUNK) * kernels.K1_CHUNK
    assert plan.smem_bytes <= H100_LIMITS[1]


def test_k1_plan_stages_large_models():
    """Models that do not fit in shared memory are staged a pass at a
    time (C 5, k 12, L 2000: three passes of two classes), or in windows
    of L (L 3000, several warps a CTA); a k whose scores do not fit beside
    one warp's ring is refused."""
    plan = kernels.k1_plan(1000, 2000, 5, 12, 4, *H100_LIMITS)
    assert not plan.resident and plan.window == 2000
    plan = kernels.k1_plan(20000, 3000, 3, 12, 4, *H100_LIMITS)
    assert not plan.resident and plan.warps == 3
    assert plan.window % kernels.K1_CHUNK == 0 and plan.window < 3000
    with pytest.raises(ValueError, match="does not fit"):
        kernels.k1_plan(100, 100, 1, 2000, 4, *H100_LIMITS)
    with pytest.raises(ValueError, match="empty"):
        kernels.k1_plan(0, 500, 3, 10, 4, *H100_LIMITS)


@pytest.mark.parametrize("case", [(4096, 500, 3, 10), (137, 96, 1, 8),
                                  (1000, 2000, 5, 12), (300, 203, 2, 40),
                                  (500, 64, 20, 1), (200, 100, 2, 33),
                                  (1, 1, 1, 1), (10 ** 6, 4000, 10, 32),
                                  (1000, 500, 100, 32), (100, 100, 1, 300),
                                  (202757, 64, 3, 10)], ids=str)
@pytest.mark.parametrize("x_bytes", [4, 2])
def test_k1_plan_is_valid(case, x_bytes):
    """Any C and k: the plan fits, its window is whole chunks (all of L
    when resident), its grid covers no more CTAs than units or SMs, and an
    invcov too large for shared memory is read from device memory."""
    n, length, c, k = case
    plan = kernels.k1_plan(n, length, c, k, x_bytes, *H100_LIMITS)
    lp = -(-length // kernels.K1_CHUNK) * kernels.K1_CHUNK
    assert plan.smem_bytes <= H100_LIMITS[1]
    assert 1 <= plan.warps <= kernels.K1_MAX_WARPS
    assert plan.stages in kernels.K1_STAGES
    assert 1 <= plan.ctas <= min(H100_LIMITS[0], -(-n // kernels.K1_UNIT))
    assert plan.window % kernels.K1_CHUNK == 0 and 0 < plan.window <= lp
    assert not plan.resident or plan.window == lp
    assert plan.icov_shared == (4 * c * k * k <= H100_LIMITS[1] // 4)


@pytest.mark.cuda
def test_float64_numpy_runs_in_float32_on_the_card(cuda):
    """F1: float64 numpy with no dtype= runs in float32 through K1 and
    K2/K3/K4/K6; an explicit float64 CUDA tensor raises ValueError at the
    entry point."""
    from ocm_tpu_torch.utils.synthetic import cheese_like

    x_tr, y_tr, x_ts, _ = cheese_like(seed=1, n_per_class=40, length=64,
                                      n_classes=3)
    assert x_tr.dtype == np.float64
    kernels.t2q_scores_multiclass.launches = 0
    est = TS.SIMCA(n_components=4, model_class=0, verbose=False)
    pred = est.fit(x_tr, y_tr).predict(x_ts)
    models = TS.fit_classes(x_tr, y_tr, [0, 1, 2], 4)
    assert models.mean.dtype == torch.float32 and models.mean.is_cuda
    accept, dred, _, _ = TS.predict_classes(models, x_ts)
    torch.cuda.synchronize()
    assert kernels.t2q_scores_multiclass.launches == 2
    assert pred.shape == (len(x_ts), 1) and dred.dtype == torch.float32
    with pytest.raises(ValueError, match="float64 on CUDA.*K1"):
        TS.predict_classes(models, torch.as_tensor(x_ts, device=cuda))

    bn.bn_act_fwd.launches = bn.bn_act_bwd.launches = 0
    small = dict(conv_blocks=2, n_filters=4, hidden_fc=16)
    r = TT.train_vae(TV.ConvVAE1D(64, 4, **small), x_tr[:48], x_tr[48:64],
                     TT.TrainConfig(epochs=2, batch_size=16), 0)
    torch.cuda.synchronize()
    assert r.bundle.spec_mean.dtype == torch.float32
    assert bn.bn_act_fwd.launches == bn.bn_act_bwd.launches == 4 * 3 * 2
    assert np.isfinite(r.train_losses).all()
    with pytest.raises(ValueError, match="float64 on CUDA.*K2"):
        TT.train_vae(TV.ConvVAE1D(64, 4, **small),
                     torch.as_tensor(x_tr[:48], device=cuda), x_tr[48:64],
                     TT.TrainConfig(epochs=1), 0)


@pytest.mark.cuda
def test_kernel_rejects_float64(cuda):
    x = torch.zeros(8, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        kernels.t2q_scores_multiclass(x, x[:1], x[None, :1], x[None, :1, :1])


# (B, C, L, act): the six BatchNorm shapes of the entry model's train step
# at B 64 cut to B 8 (K2 clusters of 8, 4, 2, 4, 8 blocks), ragged shapes,
# the other activations, one channel, a cluster of one block (C 300), a
# channel too large for registers (re-read to normalise) and L = 1
BN_CASES = [(8, 32, 501, "elu"), (8, 64, 251, "elu"), (8, 128, 126, "elu"),
            (8, 64, 252, "elu"), (8, 32, 504, "elu"), (3, 5, 7, "elu"),
            (8, 32, 501, "gelu"), (2, 3, 1000, "none"), (1, 2, 3, "elu"),
            (16, 1, 300, "elu"), (4, 300, 64, "elu"), (64, 2, 40000, "elu"),
            (64, 8, 1, "elu"), (512, 4, 1, "gelu")]
# the (B, C, L) of every BatchNorm of the entry model's train step
TRAIN_BN_SHAPES = [(64, 32, 501), (64, 64, 251), (64, 128, 126),
                   (64, 64, 252), (64, 32, 504), (64, 32, 504)]


def test_k2_cluster_size_is_valid():
    """K2's cluster: 1-8 blocks (the portable size: a cluster whose blocks
    each fit an SM is always co-resident), a power of two, ~256 blocks at
    the train step's shapes with every share in registers, one block
    where a channel has fewer elements than a block has threads."""
    got = [bn.k2_cluster_size(*shape) for shape in TRAIN_BN_SHAPES]
    assert got == [8, 4, 2, 4, 8, 8]
    edges = TRAIN_BN_SHAPES + [c[:3] for c in BN_CASES] + [
        (1, 1, 1), (1024, 1, 4096), (64, 4096, 8), (2, 7, 5000)]
    for nb, nc, nl in edges:
        size = bn.k2_cluster_size(nb, nc, nl)
        assert 1 <= size <= 8 and size & (size - 1) == 0, (nb, nc, nl)
        n = nb * nl
        assert size == 1 or n >= size * bn.K2_THREADS, (nb, nc, nl)
    for nb, nc, nl in TRAIN_BN_SHAPES:
        size = bn.k2_cluster_size(nb, nc, nl)
        assert nc * size >= bn.K2_BLOCKS
        assert -(-nb * nl // size) <= bn.K2_ITEMS * bn.K2_THREADS


@pytest.mark.parametrize("shape", TRAIN_BN_SHAPES, ids=str)
def test_k3_cluster_size_is_valid(shape):
    """K3 runs K2's launch (``k2_cluster_size``): at each train-step shape
    ~256 blocks in all, and a block's share of x and of dout (two arrays of
    K2_ITEMS a thread) in registers, so x and dout are read once."""
    nb, nc, nl = shape
    size = bn.k2_cluster_size(nb, nc, nl)
    assert size == {32: 8, 64: 4, 128: 2}[nc]
    assert nc * size == bn.K2_BLOCKS
    assert -(-nb * nl // size) <= bn.K2_ITEMS * bn.K2_THREADS


@pytest.mark.cuda
@pytest.mark.parametrize("case", BN_CASES, ids=str)
def test_bn_kernels_match_plain_twins(cuda, case):
    nb, nc, nl, act = case
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(nb, nc, nl, generator=gen) * 1.5 + 0.3).to(cuda)
    g = (torch.rand(nc, generator=gen) + 0.5).to(cuda)
    b = (torch.randn(nc, generator=gen) * 0.5).to(cuda)
    dout = torch.randn(nb, nc, nl, generator=gen).to(cuda)
    before = (bn.bn_act_fwd.launches, bn.bn_act_bwd.launches)
    out, mean, var = bn.bn_act_fwd(x, g, b, 1e-5, act)
    dx, dg, db = bn.bn_act_bwd(x, g, b, mean, var, dout, 1e-5, act)
    torch.cuda.synchronize()
    assert (bn.bn_act_fwd.launches, bn.bn_act_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = bn.bn_act_fwd_plain(x, g, b, 1e-5, act)
    ref_b = bn.bn_act_bwd_plain(x, g, b, mean, var, dout, 1e-5, act)
    # f32 sums of B*L terms in another order: the statistics and dgamma/
    # dbeta agree to ~1e-6 relative, elementwise outputs to ~1e-5
    for got, want, what in zip((out, mean, var, dx, dg, db),
                               (*ref, *ref_b),
                               ("out", "mean", "var", "dx", "dg", "db")):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * want.abs().max().item(),
                                   msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("nl", [252, 126, 7], ids=str)
def test_bn_forward_unaligned_x_matches_plain_twin(cuda, nl):
    """x off 16- and 8-byte alignment: K2 falls back to narrower loads."""
    gen = torch.Generator().manual_seed(7)
    nb, nc = 8, 32
    flat = torch.randn(nb * nc * nl + 1, generator=gen).to(cuda)
    x = flat[1:].view(nb, nc, nl)
    g = (torch.rand(nc, generator=gen) + 0.5).to(cuda)
    b = (torch.randn(nc, generator=gen) * 0.5).to(cuda)
    got = bn.bn_act_fwd(x, g, b)
    torch.cuda.synchronize()
    for a, want in zip(got, bn.bn_act_fwd_plain(x, g, b, 1e-5, "elu")):
        torch.testing.assert_close(a, want, rtol=1e-4,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("nl", [252, 126, 7], ids=str)
def test_bn_backward_unaligned_x_matches_plain_twin(cuda, nl):
    """x and dout off 16- and 8-byte alignment: K3 falls back to narrower
    loads."""
    gen = torch.Generator().manual_seed(8)
    nb, nc = 8, 32
    x, dout = (torch.randn(nb * nc * nl + 1, generator=gen).to(cuda)[1:]
               .view(nb, nc, nl) for _ in range(2))
    g = (torch.rand(nc, generator=gen) + 0.5).to(cuda)
    b = (torch.randn(nc, generator=gen) * 0.5).to(cuda)
    mean, var = bn.bn_act_stats(x)
    got = bn.bn_act_bwd(x, g, b, mean, var, dout)
    torch.cuda.synchronize()
    for a, want in zip(got, bn.bn_act_bwd_plain(x, g, b, mean, var, dout,
                                                1e-5, "elu")):
        torch.testing.assert_close(a, want, rtol=1e-4,
                                   atol=1e-5 * want.abs().max().item())


# (B, C, L): channels of 8,000 elements (read again at cluster 1, held in
# registers at 2-8), of 128,000 (read again at every size), and of 28,
# fewer than a block's threads (empty shares at 2-8)
BN_CLUSTER_SHAPES = [(8, 4, 1000), (64, 2, 2000), (4, 3, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", BN_CLUSTER_SHAPES, ids=str)
def test_bn_kernels_at_every_cluster_size(cuda, shape, cluster):
    """K2 and K3 launched through the library at a given cluster size
    (the wrappers take k2_cluster_size's), against their twins."""
    nb, nc, nl = shape
    gen = torch.Generator().manual_seed(9)
    x = (torch.randn(nb, nc, nl, generator=gen) * 1.5 + 0.3).to(cuda)
    dout = torch.randn(nb, nc, nl, generator=gen).to(cuda)
    g = (torch.rand(nc, generator=gen) + 0.5).to(cuda)
    b = (torch.randn(nc, generator=gen) * 0.5).to(cuda)
    out, dx = torch.empty_like(x), torch.empty_like(x)
    mean, var, dg, db = (torch.empty(nc, device=cuda) for _ in range(4))
    lib, stream = _build.library(), kernels.stream_of(x)
    _build.check(lib.bn_act_fwd_f32(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
        mean.data_ptr(), var.data_ptr(), nb, nc, nl, 1e-5, 0, cluster,
        stream), "bn_act_fwd")
    _build.check(lib.bn_act_bwd_f32(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), mean.data_ptr(),
        var.data_ptr(), dout.data_ptr(), dx.data_ptr(), dg.data_ptr(),
        db.data_ptr(), nb, nc, nl, 1e-5, 0, cluster, stream), "bn_act_bwd")
    torch.cuda.synchronize()
    want = (*bn.bn_act_fwd_plain(x, g, b, 1e-5, "elu"),
            *bn.bn_act_bwd_plain(x, g, b, mean, var, dout, 1e-5, "elu"))
    for got, ref, what in zip((out, mean, var, dx, dg, db), want,
                              ("out", "mean", "var", "dx", "dg", "db")):
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-5 * ref.abs().max().item(),
                                   msg=what)


# (N, k): the train batch (one block, float4 lanes), odd k, one element,
# k above 32 (one lane two vectors), ragged k, a long batch, k past 128
REPARAM_CASES = [(64, 16), (300, 5), (7, 40), (1, 1), (7, 33), (1000, 64),
                 (3, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", REPARAM_CASES, ids=str)
def test_reparam_kernel_matches_plain_twin(cuda, shape):
    gen = torch.Generator().manual_seed(1)
    mu, lv, eps = (torch.randn(3, *shape, generator=gen) * 0.8).to(cuda)
    before = kernels.reparam_kl.launches
    z, kl = kernels.reparam_kl(mu, lv, eps)
    torch.cuda.synchronize()
    assert kernels.reparam_kl.launches == before + 1
    z_p, kl_p = kernels.reparam_kl_plain(mu, lv, eps)
    torch.testing.assert_close(z, z_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kl, kl_p, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [1, 2], ids=["4B", "8B"])
@pytest.mark.parametrize("shape", [(64, 16), (1000, 64)], ids=str)
def test_reparam_kernel_unaligned_matches_plain_twin(cuda, shape, shift):
    """mu's base 4 or 8 bytes past 16-byte alignment: the plan falls back
    to 8-byte or scalar accesses."""
    gen = torch.Generator().manual_seed(4)
    n, k = shape
    mu = (torch.randn(n * k + shift, generator=gen) * 0.8).to(cuda)[shift:]
    mu = mu.view(n, k)
    lv, eps = (torch.randn(2, n, k, generator=gen) * 0.8).to(cuda)
    z, kl = kernels.reparam_kl(mu, lv, eps)
    torch.cuda.synchronize()
    z_p, kl_p = kernels.reparam_kl_plain(mu, lv, eps)
    torch.testing.assert_close(z, z_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kl, kl_p, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dz_kind", ["contiguous", "transposed", "offset",
                                     "unused"])
@pytest.mark.parametrize("shape", [(64, 16), (300, 5), (7, 33), (3, 129)],
                         ids=str)
def test_reparam_bwd_kernel_matches_plain_twin(cuda, shape, dz_kind):
    """K6's backward kernel against its twin, with dkl the stride-0 expand
    of kl.mean()'s gradient, and dz contiguous, non-contiguous, off
    alignment, or the zeros autograd makes when z goes unused; one launch
    a call, within 1e-5 of scale (elementwise f32 exp)."""
    gen = torch.Generator().manual_seed(3)
    n, k = shape
    mu, lv, eps, dz = (torch.randn(4, n, k, generator=gen) * 0.8).to(cuda)
    if dz_kind == "transposed":
        dz = dz.T.contiguous().T
    elif dz_kind == "offset":
        dz = torch.randn(n * k + 1, generator=gen).to(cuda)[1:].view(n, k)
    m, v = mu.clone().requires_grad_(), lv.clone().requires_grad_()
    before = kernels.reparam_kl_bwd.launches
    z, kl = kernels.fused_reparam_kl(m, v, eps)
    if dz_kind == "unused":
        kl.mean().backward()
        dz = torch.zeros_like(mu)
    else:
        torch.autograd.backward((z, kl.mean()), (dz, None))
    torch.cuda.synchronize()
    assert kernels.reparam_kl_bwd.launches == before + 1
    dkl = torch.full((), 1.0 / n, device=cuda).expand(n)
    ref = kernels.reparam_kl_bwd_plain(mu, lv, eps, dz, dkl)
    direct = kernels.reparam_kl_bwd(mu, lv, eps, dz, dkl)
    torch.cuda.synchronize()
    for got in ((m.grad, v.grad), direct):
        for a, r in zip(got, ref):
            torch.testing.assert_close(a, r, rtol=1e-5,
                                       atol=1e-5 * r.abs().max().item())


@pytest.mark.cuda
def test_reparam_kernels_after_a_linear_match_plain_twins(cuda):
    """K4, K6's backward and K5 are programmatic dependents of the kernel
    before them: launched straight after the Linear that writes their
    input, each must read its output, not the buffer's earlier contents
    (every rep writes new values into the recycled block)."""
    gen = torch.Generator().manual_seed(8)
    fc = torch.nn.Linear(256, 16).to(cuda).requires_grad_(False)
    mu, lv, eps = (torch.randn(3, 64, 16, generator=gen) * 0.8).to(cuda)
    dkl = torch.full((), 1.0 / 64, device=cuda).expand(64)
    hs = [torch.randn(64, 256, generator=gen).to(cuda) for _ in range(10)]
    got = [(kernels.reparam_kl(mu, fc(h), eps),
            kernels.reparam_kl_bwd(mu, lv, eps, fc(h), dkl),
            kernels.reparam_kl_sample(mu, fc(h), i))
           for i, h in enumerate(hs)]
    torch.cuda.synchronize()
    for i, (h, (k4, k6, k5)) in enumerate(zip(hs, got)):
        out = fc(h)
        for res, ref in ((k4, kernels.reparam_kl_plain(mu, out, eps)),
                         (k6, kernels.reparam_kl_bwd_plain(mu, lv, eps, out,
                                                           dkl)),
                         (k5, kernels.reparam_kl_sample_plain(mu, out, i))):
            for a, r in zip(res, ref):
                torch.testing.assert_close(a, r, rtol=1e-5,
                                           atol=1e-5 * r.abs().max().item())


@pytest.mark.cuda
def test_reparam_entry_points_refuse_a_wrong_plan(cuda):
    mu = torch.zeros(64, 16, device=cuda)
    z, kl = torch.empty_like(mu), torch.empty(64, device=cuda)
    plan = kernels.reparam_plan(64, 16)
    lib = _build.library()
    stream = kernels.stream_of(mu)
    ptrs = (mu.data_ptr(),) * 3 + (z.data_ptr(), kl.data_ptr())
    assert lib.reparam_kl_f32(*ptrs, 64, 16, *plan, stream) == 0
    for bad in (plan._replace(lanes=8), plan._replace(blocks=2),
                plan._replace(vec=4)):
        assert lib.reparam_kl_f32(*ptrs, 64, 16, *bad, stream) != 0
    sampled = kernels.reparam_plan(64, 16, sampled=True)
    args = (mu.data_ptr(), mu.data_ptr(), z.data_ptr(), kl.data_ptr(), None,
            64, 16, 1, 0)
    assert lib.reparam_kl_sample_f32(*args, *sampled, stream) == 0
    assert lib.reparam_kl_sample_f32(*args, *plan, stream) != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_noop_counts_its_launches(cuda):
    before = kernels.noop.launches
    kernels.noop(cuda)
    torch.cuda.synchronize()
    assert kernels.noop.launches == before + 1


@pytest.mark.cuda
def test_vae_kernels_reject_float64(cuda):
    x = torch.zeros(2, 3, 4, dtype=torch.float64, device=cuda)
    c = torch.ones(3, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        bn.bn_act_fwd(x, c, c)
    with pytest.raises(TypeError, match="float32"):
        kernels.reparam_kl(x[0], x[0], x[0])
    with pytest.raises(TypeError, match="float32"):
        kernels.reparam_kl_sample(x[0], x[0], 0)


# (N, k): the calibration's and the sampled entry forward's latent shapes,
# the screen chunk's, ragged rows with k odd (element pairs straddle rows),
# odd k above 32 and past 128, k above 32, one element
SAMPLE_CASES = [(512, 16), (64, 16), (65536, 16), (300, 5), (7, 33),
                (3, 129), (7, 40), (1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SAMPLE_CASES, ids=str)
def test_reparam_sample_kernel_matches_plain_twin(cuda, shape):
    gen = torch.Generator().manual_seed(2)
    mu, lv = (torch.randn(2, *shape, generator=gen) * 0.8).to(cuda)
    seed, offset = 0x1234_5678_9ABC_DEF0, 3
    before = kernels.reparam_kl_sample.launches
    z, kl, eps = kernels.reparam_kl_sample(mu, lv, seed, offset,
                                           return_eps=True)
    torch.cuda.synchronize()
    assert kernels.reparam_kl_sample.launches == before + 1
    z_p, kl_p, eps_p = kernels.reparam_kl_sample_plain(mu, lv, seed, offset)
    # the same bits through the same f32 log, cos and sqrt: the noise is
    # equal bit for bit; z and the KL within 1e-5 (exp, a fused
    # multiply-add, the row sum's order)
    assert torch.equal(eps, eps_p)
    torch.testing.assert_close(z, z_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kl, kl_p, rtol=1e-5, atol=1e-5)
    z2, kl2 = kernels.reparam_kl_sample(mu, lv, seed, offset)
    assert torch.equal(z2, z) and torch.equal(kl2, kl)
    if mu.numel() > 1:
        assert not torch.equal(kernels.reparam_kl_sample(mu, lv, seed + 1,
                                                         offset)[0], z)
        assert not torch.equal(kernels.reparam_kl_sample(mu, lv, seed,
                                                         offset + 1)[0], z)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 16), (7, 33)], ids=str)
def test_reparam_sample_kernel_unaligned_matches_plain_twin(cuda, shape):
    """mu 4 bytes off 8-byte alignment: scalar accesses, the same noise."""
    gen = torch.Generator().manual_seed(6)
    n, k = shape
    mu = (torch.randn(n * k + 1, generator=gen) * 0.8).to(cuda)[1:]
    mu = mu.view(n, k)
    lv = (torch.randn(n, k, generator=gen) * 0.8).to(cuda)
    z, kl, eps = kernels.reparam_kl_sample(mu, lv, 11, 2, return_eps=True)
    torch.cuda.synchronize()
    z_p, kl_p, eps_p = kernels.reparam_kl_sample_plain(mu, lv, 11, 2)
    assert torch.equal(eps, eps_p)
    torch.testing.assert_close(z, z_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kl, kl_p, rtol=1e-5, atol=1e-5)


# (N, L, tile): the probe's --small shape, a headline tile cut in N, a
# ragged one (L 203: tiles not 16-byte aligned, read byte by byte), a tile
# of 8 rows under the K8 block of 64, one tile holding every row
INT8_CASES = [(1024, 128, 256), (4096, 512, 512), (1000, 203, 8),
              (640, 500, 64), (96, 36, 96)]


def _int8(shape, gen, cuda, offset=0):
    """A contiguous int8 (N, L) tensor whose base lies ``offset`` bytes past
    an allocation's (aligned) start."""
    flat = torch.randint(-127, 128, (math.prod(shape) + offset,),
                         dtype=torch.int8, generator=gen).to(cuda)
    return flat[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("case", INT8_CASES, ids=str)
def test_int8_tile_sum_matches_plain_twin(cuda, case):
    n, length, tile = case
    xq = _int8((n, length), torch.Generator().manual_seed(3), cuda)
    before = kernels.int8_tile_sum.launches
    got = kernels.int8_tile_sum(xq, tile)
    torch.cuda.synchronize()
    assert kernels.int8_tile_sum.launches == before + 1
    assert torch.equal(got, kernels.int8_tile_sum_plain(xq, tile))


@pytest.mark.cuda
@pytest.mark.parametrize("case", INT8_CASES, ids=str)
def test_int8_gemm_tile_sums_match_plain_twin(cuda, case):
    n, length, tile = case
    gen = torch.Generator().manual_seed(4)
    xq, w = _int8((n, length), gen, cuda), _int8((128, length), gen, cuda)
    before = kernels.int8_gemm_s32.launches
    got = kernels.int8_gemm_s32(xq, w, tile)
    torch.cuda.synchronize()
    assert kernels.int8_gemm_s32.launches == before + 1
    assert torch.equal(got, kernels.int8_gemm_s32_plain(xq, w, tile))


# (N, L, M): the scoring shape cut in N (3 classes, k 10: 2 x 33 columns),
# ragged rows and L, a column count that is not a multiple of 4, one
# column, and more columns than one block holds
GEMM_CASES = [(4096, 500, 66), (1001, 203, 66), (257, 96, 7), (64, 4, 1),
              (300, 64, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GEMM_CASES, ids=str)
def test_int8_gemm_store_matches_plain_twin(cuda, case):
    n, length, m = case
    gen = torch.Generator().manual_seed(5)
    xq, w = _int8((n, length), gen, cuda), _int8((m, length), gen, cuda)
    got = kernels.int8_gemm_s32(xq, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (n, m)
    assert torch.equal(got, kernels.int8_gemm_s32_plain(xq, w))


# K8's edges: rows N around its 64-row tiles and a large ragged N, row
# lengths L of the scoring op (500: one bulk copy a tile), the probe (512: a
# copy a row), not 4-byte multiples (203: the dp4a kernel), short rows;
# columns M of one, the scoring op, the probe, and more than one 128-column
# tile; each pair (N, L) against every M
GEMM_NS, GEMM_LS, GEMM_MS = (1, 63, 64, 65, 65553), (500, 512, 203, 36, 4), \
    (1, 66, 128, 200)


@pytest.mark.cuda
@pytest.mark.parametrize("n,length", list(itertools.product(GEMM_NS, GEMM_LS)),
                         ids=str)
def test_int8_gemm_store_edges_match_plain_twin(cuda, n, length):
    gen = torch.Generator().manual_seed(8)
    xq = _int8((n, length), gen, cuda)
    for m in GEMM_MS:
        w = _int8((m, length), gen, cuda)
        before = kernels.int8_gemm_s32.launches
        got = kernels.int8_gemm_s32(xq, w)
        torch.cuda.synchronize()
        assert kernels.int8_gemm_s32.launches == before + 1
        assert got.shape == (n, m)
        assert torch.equal(got, kernels.int8_gemm_s32_plain(xq, w)), m


# (N, L, M, x offset, w offset): bases off alignment (x by 1 byte, the dp4a
# kernel; w by 1 byte; x 4- but not 16-byte aligned), and rows too long for
# w and two stages in shared memory
GEMM_ODD_CASES = [(1000, 500, 66, 1, 0), (65, 512, 128, 1, 0),
                  (300, 500, 66, 0, 1), (257, 512, 66, 4, 0),
                  (257, 4096, 66, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GEMM_ODD_CASES, ids=str)
def test_int8_gemm_odd_operands_match_plain_twin(cuda, case):
    n, length, m, x_off, w_off = case
    gen = torch.Generator().manual_seed(9)
    xq, w = _int8((n, length), gen, cuda, x_off), _int8((m, length), gen,
                                                         cuda, w_off)
    assert (xq.data_ptr() % 16 != 0) == bool(x_off)
    got = kernels.int8_gemm_s32(xq, w)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.int8_gemm_s32_plain(xq, w))
    tiles = kernels.int8_gemm_s32(xq[:n - n % 8], w, 8)
    torch.cuda.synchronize()
    assert torch.equal(tiles, kernels.int8_gemm_s32_plain(xq[:n - n % 8], w, 8))


# (L, M, tile) of the tile sums on 1,024 rows: tiles of one row and of 8
# (one atomic an element), 512 (a warp's rows summed in registers)
@pytest.mark.cuda
@pytest.mark.parametrize("case", list(itertools.product(
    (500, 512, 203), (66, 128, 200), (1, 8, 512))), ids=str)
def test_int8_gemm_tile_edges_match_plain_twin(cuda, case):
    length, m, tile = case
    gen = torch.Generator().manual_seed(10)
    xq, w = _int8((1024, length), gen, cuda), _int8((m, length), gen, cuda)
    got = kernels.int8_gemm_s32(xq, w, tile)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.int8_gemm_s32_plain(xq, w, tile))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(4096, 500, 3, 10), (300, 203, 2, 40),
                                  (137, 96, 1, 8), (100, 500, 3, 10),
                                  (8191, 500, 3, 10), (202757, 64, 3, 10),
                                  (1000, 2000, 5, 12), (20000, 3000, 3, 12)],
                         ids=str)
def test_bf16_kernel_matches_plain_twin(cuda, case):
    n, length, c, k = case
    gen = torch.Generator().manual_seed(6)
    x = (0.1 * torch.randn(n, length, generator=gen)).to(cuda, torch.bfloat16)
    means = 0.05 * torch.randn(c, length, generator=gen)
    comps = torch.linalg.qr(torch.randn(c, length, k, generator=gen))[0].mT
    a = torch.randn(c, k, k, generator=gen)
    args = [x] + [t.to(cuda, torch.float32).contiguous()
                  for t in (means, comps, a @ a.mT / k + torch.eye(k))]
    before = (kernels.t2q_scores_multiclass.launches,
              kernels.t2q_scores_multiclass.launches_bf16)
    t2, q = kernels.t2q_scores_multiclass(*args)
    torch.cuda.synchronize()
    assert (kernels.t2q_scores_multiclass.launches,
            kernels.t2q_scores_multiclass.launches_bf16) == (
        before[0], before[1] + 1)
    t2_p, q_p = kernels.t2q_scores_multiclass_plain(*args)
    xc2 = ((args[0].float()[None] - args[1][:, None]) ** 2).sum(-1)
    # the same widened values on both sides: f32 sums in another order
    torch.testing.assert_close(t2, t2_p, rtol=1e-4,
                               atol=1e-6 * t2_p.abs().mean().item())
    assert torch.all((q - q_p).abs() <= 1e-4 * xc2)


@pytest.mark.cuda
def test_int8_kernels_reject_other_dtypes(cuda):
    x = torch.zeros(8, 4, dtype=torch.int16, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        kernels.int8_tile_sum(x, 2)
    with pytest.raises(TypeError, match="int8"):
        kernels.int8_gemm_s32(x, x)


@pytest.mark.cuda
def test_uint16_chunk_widens_on_the_card(cuda):
    """The raw-ingest scorer ships uint16 counts and widens them on the
    card: torch must convert a uint16 CUDA tensor to f32."""
    counts = np.array([[0, 1, 65535, 40000]], dtype=np.uint16)
    got = torch.from_numpy(counts).to(cuda).to(torch.float32)
    assert got.cpu().numpy().tolist() == [[0.0, 1.0, 65535.0, 40000.0]]


def _unequal_masked_models(cuda, k):
    """Three classes of 70, 52 and 34 spectra of 96 channels, fitted by
    the masked fit on the card (f32)."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 96)
    counts = (70, 52, 34)
    x = np.concatenate([
        rng.normal(1, .08, (n, 1)) * np.sin(2 * np.pi * (3 + c) * t)
        + 0.3 * c + rng.normal(0, .02, (n, 96))
        for c, n in enumerate(counts)]).astype(np.float32)
    y = np.repeat([0, 1, 2], counts)
    return x, y, TS.fit_classes(x, y, [0, 1, 2], k, solver="eigh",
                                device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 12])
def test_kernel_on_masked_fit_models(cuda, k):
    """K1 on a masked fit's stacked models (unequal counts) equals its
    plain twin, one launch for the three classes."""
    x, _, models = _unequal_masked_models(cuda, k)
    args = [torch.as_tensor(x, device=cuda)] + [
        a.contiguous() for a in (models.mean, models.components,
                                 models.invcovT)]
    before = kernels.t2q_scores_multiclass.launches
    t2, q = kernels.t2q_scores_multiclass(*args)
    torch.cuda.synchronize()
    assert kernels.t2q_scores_multiclass.launches == before + 1
    t2_p, q_p = kernels.t2q_scores_multiclass_plain(*args)
    xc2 = ((args[0][None] - args[1][:, None]) ** 2).sum(-1)
    assert ((t2 - t2_p).abs() / t2_p.abs()).max().item() < 1e-4
    assert ((q - q_p).abs() / xc2).max().item() < 1e-5


@pytest.mark.cuda
def test_simca_predict_launches(cuda):
    """``SIMCA.predict``: one K1 launch for every class at one k (models
    stacked), one a class at a k each (here 4, 8, 12), each equal to
    its class's own plain scores."""
    x, y, _ = _unequal_masked_models(cuda, 4)
    for ncomp, launches in ((8, 1), ([4, 8, 12], 3)):
        est = TS.SIMCA(n_components=ncomp, model_class=[0, 1, 2],
                       solver="rsvd", verbose=False, device=cuda).fit(x, y)
        before = kernels.t2q_scores_multiclass.launches
        pred = est.predict(x)
        assert kernels.t2q_scores_multiclass.launches == before + launches
        for i, cls in enumerate(est.model_class):
            m = est._model[cls]
            t2, q = kernels.t2q_scores_multiclass_plain(
                torch.as_tensor(x, device=cuda), m.mean[None],
                m.components[None], m.invcovT[None])
            dred = TS.L.reduced_distance("alt", t2[0], q[0], m.t2_res,
                                         m.q_res)
            agree = np.mean(pred[:, i] == (dred < m.d_limit).cpu().numpy())
            assert agree >= 0.999


# the nut pipeline's screen (examples/hsi_pipeline.py --cube-scale): chunks
# of 65,536 pixel spectra of 288 channels against 3 classes at k 10, and
# SIMCA.predict of the nuts splits (one class at k 12)
NUT_CHUNK, NUT_L = 65536, 288


@pytest.mark.parametrize("n,c,k,x_bytes", [(NUT_CHUNK, 3, 10, 4),
                                           (NUT_CHUNK, 3, 10, 2),
                                           (30000, 1, 12, 4)], ids=str)
def test_k1_plan_at_the_nut_pipeline_shapes(n, c, k, x_bytes):
    """At L 288 (a whole number of 32-column chunks) every model stays
    resident, with 4 stages: a plan the bench shapes (L 500, 3 stages) do
    not reach."""
    plan = kernels.k1_plan(n, NUT_L, c, k, x_bytes, *H100_LIMITS)
    assert plan.resident and plan.window == NUT_L and plan.stages == 4
    assert plan.smem_bytes <= H100_LIMITS[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_k1_at_the_nut_pipeline_shape(cuda, dtype):
    gen = torch.Generator().manual_seed(18)
    x = (0.1 * torch.randn(NUT_CHUNK, NUT_L, generator=gen)).to(cuda, dtype)
    means = 0.05 * torch.randn(3, NUT_L, generator=gen)
    comps = torch.linalg.qr(torch.randn(3, NUT_L, 10, generator=gen))[0].mT
    a = torch.randn(3, 10, 10, generator=gen)
    args = [x] + [t.to(cuda, torch.float32).contiguous()
                  for t in (means, comps, a @ a.mT / 10 + torch.eye(10))]
    t2, q = kernels.t2q_scores_multiclass(*args)
    torch.cuda.synchronize()
    t2_p, q_p = kernels.t2q_scores_multiclass_plain(*args)
    xc2 = ((args[0].float()[None] - args[1][:, None]) ** 2).sum(-1)
    torch.testing.assert_close(t2, t2_p, rtol=1e-4,
                               atol=1e-6 * t2_p.abs().mean().item())
    assert torch.all((q - q_p).abs() <= 1e-4 * xc2)


@pytest.mark.cuda
def test_k8_at_the_nut_pipeline_shape(cuda):
    """The int8 screen's product: a chunk of 65,536 x 288 against the two
    levels of 3 classes' loadings and means (2 (3 * 10 + 3) rows)."""
    gen = torch.Generator().manual_seed(19)
    xq = torch.randint(-127, 128, (NUT_CHUNK, NUT_L), dtype=torch.int8,
                       generator=gen).to(cuda)
    w = torch.randint(-127, 128, (66, NUT_L), dtype=torch.int8,
                      generator=gen).to(cuda)
    got = kernels.int8_gemm_s32(xq, w)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.int8_gemm_s32_plain(xq, w))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["svd", "rsvd"])
def test_outlier_mask_on_the_card_matches_cpu_f64(cuda, solver):
    """``mahalanobis_outlier_mask`` in f32 on the card against the CPU in
    f64 on the same pixels (rsvd with the card's test matrix): keep masks
    >= 99.9 % equal, distances within 1e-3 of their scale."""
    from ocm_tpu_torch.ops.linalg import default_omega
    from ocm_tpu_torch.utils.outliers import mahalanobis_outlier_mask

    rng = np.random.default_rng(20)
    scales = np.array([10, 8, 6, 5, 4, 3, 2.5, 2, 1.5, 1.2, 1, 0.8])
    loadings = np.linalg.qr(rng.normal(size=(NUT_L, 12)))[0].T
    x = (rng.normal(size=(20000, 12)) * scales) @ loadings + rng.normal(
        0, 0.05, (20000, NUT_L))
    omega = default_omega(NUT_L, 20, torch.float32, cuda)
    keep, dist, thr = mahalanobis_outlier_mask(
        x.astype(np.float32), 10, solver=solver, device=cuda, omega=omega)
    keep64, dist64, thr64 = mahalanobis_outlier_mask(
        x, 10, solver=solver, device="cpu", omega=omega.double().cpu())
    agree = (keep.cpu() == keep64).double().mean().item()
    assert agree >= 0.999, agree
    err = (dist.double().cpu() - dist64).abs().max().item()
    assert err <= 1e-3 * dist64.abs().max().item()
    assert abs(float(thr) - float(thr64)) <= 1e-3 * float(thr64)


# the (B, C*F, L) of the stacked entry model's BatchNorms at 8 configs, and
# C*F above 1,024 (16 configs of 128 filters; 32 of the entry model's 128)
STACKED_BN_CASES = [(64, 256, 501), (64, 512, 251), (64, 1024, 126),
                    (64, 512, 252), (64, 256, 504), (64, 2048, 126),
                    (64, 4096, 126), (8, 1536, 33)]


def test_k2_cluster_size_at_the_stacked_shapes():
    """Stacking configs on the channel axis keeps each channel's cluster:
    the 8-config entry model's BatchNorms split every channel as the
    single model's do (8, 4, 2 blocks at L 501, 251, 126), so a channel's
    sums take the same blocks and order."""
    for (nb, nc, nl), single in zip(STACKED_BN_CASES[:5],
                                    TRAIN_BN_SHAPES[:5]):
        assert nc == 8 * single[1] and (nb, nl) == (single[0], single[2])
        assert bn.k2_cluster_size(nb, nc, nl) == bn.k2_cluster_size(*single)
    for nb, nc, nl in STACKED_BN_CASES:
        size = bn.k2_cluster_size(nb, nc, nl)
        assert 1 <= size <= 8 and size & (size - 1) == 0
        assert -(-nb * nl // size) <= bn.K2_ITEMS * bn.K2_THREADS


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STACKED_BN_CASES, ids=str)
def test_bn_kernels_at_the_stacked_shapes(cuda, shape):
    """K2 and K3 against their twins at the stacked shapes, one launch
    each (tolerances as ``test_bn_kernels_match_plain_twins``)."""
    gen = torch.Generator().manual_seed(10)
    x = (torch.randn(*shape, generator=gen) * 1.5 + 0.3).to(cuda)
    g = (torch.rand(shape[1], generator=gen) + 0.5).to(cuda)
    b = (torch.randn(shape[1], generator=gen) * 0.5).to(cuda)
    dout = torch.randn(*shape, generator=gen).to(cuda)
    before = (bn.bn_act_fwd.launches, bn.bn_act_bwd.launches)
    out, mean, var = bn.bn_act_fwd(x, g, b, 1e-5, "elu")
    dx, dg, db = bn.bn_act_bwd(x, g, b, mean, var, dout, 1e-5, "elu")
    torch.cuda.synchronize()
    assert (bn.bn_act_fwd.launches, bn.bn_act_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = (*bn.bn_act_fwd_plain(x, g, b, 1e-5, "elu"),
           *bn.bn_act_bwd_plain(x, g, b, mean, var, dout, 1e-5, "elu"))
    for got, want in zip((out, mean, var, dx, dg, db), ref):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("n_cfg", [3, 8])
def test_reparam_bwd_with_a_per_config_dkl(cuda, n_cfg):
    """K6's backward as the stacked loss sum_c beta_c * mean(kl_c) hands
    it dkl: beta_c / B, different per config; one launch, equal to its
    twin within 1e-5 of scale."""
    gen = torch.Generator().manual_seed(4)
    batch, k = 64, 16
    mu, lv, eps, w = (torch.randn(4, n_cfg * batch, k, generator=gen)
                      * 0.8).to(cuda)
    betas = torch.logspace(-3, 0.6, n_cfg, device=cuda)
    m, v = mu.clone().requires_grad_(), lv.clone().requires_grad_()
    z, kl = kernels.fused_reparam_kl(m, v, eps)
    caught = {}
    kl.register_hook(lambda g: caught.__setitem__("dkl", g))
    before = kernels.reparam_kl_bwd.launches
    ((w * z).sum() + (betas * kl.view(n_cfg, batch).mean(1)).sum()
     ).backward()
    torch.cuda.synchronize()
    assert kernels.reparam_kl_bwd.launches == before + 1
    dkl = caught["dkl"]
    assert torch.unique(dkl).numel() == n_cfg
    ref = kernels.reparam_kl_bwd_plain(mu, lv, eps, w, dkl)
    for a, r in zip((m.grad, v.grad), ref):
        torch.testing.assert_close(a, r, rtol=1e-5,
                                   atol=1e-5 * r.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("n_cfg", [1, 3, 8])
def test_stacked_step_launches_whatever_the_configs(cuda, n_cfg):
    """One stacked train step of the entry model launches 6 K2, 6 K3, 1 K4
    and 1 K6 backward, at 1, 3 or 8 configs."""
    from ocm_tpu_torch.models import stacked

    template = TV.ConvVAE1D(501, 16)
    smodel = stacked.stacked_vae(
        template, [stacked.seeded_vae(template, s) for s in range(n_cfg)],
        device=cuda)
    opt = stacked.StackedAdam(smodel, [1e-3] * n_cfg, [0.0] * n_cfg)
    step = stacked.make_stacked_train_step(
        smodel, opt, TT.TrainConfig(loss_type="cosine"), [1.0] * n_cfg)
    gen = torch.Generator().manual_seed(5)
    xb = torch.randn(n_cfg, 64, 501, generator=gen).to(cuda)
    eps = torch.randn(n_cfg, 64, 16, generator=gen).to(cuda)
    counters = (bn.bn_act_fwd, bn.bn_act_bwd, kernels.reparam_kl,
                kernels.reparam_kl_bwd)
    before = [f.launches for f in counters]
    losses = step(xb, eps)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [6, 6, 1, 1]
    assert losses.shape == (n_cfg,) and bool(torch.isfinite(losses).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TRAIN_BN_SHAPES[:3], ids=str)
def test_bn_kernels_side_by_side_equal_each_models_own(cuda, shape):
    """Three models' channels side by side, launched with one model's
    cluster size (as ``StackedBatchNormAct`` does), give each model's own
    K2/K3 results bit for bit: a channel's sums depend on the cluster
    size, B and L only."""
    gen = torch.Generator().manual_seed(11)
    nb, nc, nl = shape
    xs = [(torch.randn(nb, nc, nl, generator=gen) * 1.5 + 0.3).to(cuda)
          for _ in range(3)]
    douts = [torch.randn(nb, nc, nl, generator=gen).to(cuda)
             for _ in range(3)]
    gs = [(torch.rand(nc, generator=gen) + 0.5).to(cuda) for _ in range(3)]
    bs = [(torch.randn(nc, generator=gen) * 0.5).to(cuda) for _ in range(3)]
    size = bn.k2_cluster_size(*shape)
    x, dout = torch.cat(xs, 1), torch.cat(douts, 1)
    g, b = torch.cat(gs), torch.cat(bs)
    out, mean, var = bn.bn_act_fwd(x, g, b, 1e-5, "elu", size)
    dx, dg, db = bn.bn_act_bwd(x, g, b, mean, var, dout, 1e-5, "elu", size)
    for c in range(3):
        ch = slice(c * nc, (c + 1) * nc)
        o, m, v = bn.bn_act_fwd(xs[c], gs[c], bs[c], 1e-5, "elu")
        d = bn.bn_act_bwd(xs[c], gs[c], bs[c], m, v, douts[c], 1e-5, "elu")
        for got, want in ((out[:, ch], o), (mean[ch], m), (var[ch], v),
                          (dx[:, ch], d[0]), (dg[ch], d[1]), (db[ch], d[2])):
            assert torch.equal(got, want)


def _card_rank(rank, world, backend, init_file, results):
    """One rank of ``test_parallel_mesh_on_the_card`` on ``cuda:0``."""
    import datetime
    import traceback

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        try:
            from ocm_tpu_torch.parallel import mesh as PM
            from ocm_tpu_torch.parallel import simca_dist as PD

            mesh = PM.make_mesh()
            dev = mesh.device
            s = mesh.psum(torch.full((3,), rank + 1.0, device=dev), "data")
            g = mesh.all_gather(torch.full((2,), float(rank), device=dev),
                                "data")
            rng = np.random.default_rng(0)
            x = (rng.normal(1, .1, (256, 1)) * np.sin(np.linspace(0, 6, 60))
                 + rng.normal(0, .02, (256, 60))).astype(np.float32)
            model = PD.fit_simca_sharded(x, np.ones(256, np.float32), 4, mesh)
            ref = TS.fit_simca_masked(torch.as_tensor(x, device=dev),
                                      torch.ones(256, device=dev), 4)
            kernels.t2q_scores_multiclass.launches = 0
            acc, _, _, _ = PD.predict_sharded(model, x, mesh)
            torch.cuda.synchronize()
            results.put((rank, "ok", (
                s.cpu().tolist(), g.cpu().tolist(), float(model.d_limit),
                float(ref.d_limit), kernels.t2q_scores_multiclass.launches,
                acc.shape[0])))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, "err", traceback.format_exc()))


@pytest.mark.cuda
@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_parallel_mesh_on_the_card(cuda, tmp_path, backend, world):
    """The mesh on the card: a single-rank NCCL group, and two gloo ranks
    sharing ``cuda:0`` with CUDA tensors.  The all-reduce and the tiled
    gather are exact, the sharded fit's limit is the local masked fit's
    within 1e-4, and each rank scores its rows with one K1 launch."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_card_rank, args=(
        r, world, backend, str(tmp_path / "store"), results))
        for r in range(world)]
    for p in procs:
        p.start()
    outs = [None] * world
    try:
        for _ in range(world):
            try:
                rank, status, value = results.get(timeout=180)
            except queue.Empty:
                pytest.fail("a rank gave no answer within 180 s")
            assert status == "ok", value
            outs[rank] = value
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for s, g, d_limit, d_ref, launches, n in outs:
        assert s == [float(sum(range(1, world + 1)))] * 3
        assert g == [float(r) for r in range(world) for _ in range(2)]
        assert abs(d_limit - d_ref) <= 1e-4 * abs(d_ref)
        assert launches == 1 and n == 256 // world


# --- K9: the eval-mode conv epilogue (bn_act_eval_fused) -------------------

# (B, C, L, aligned): the nuts screens' three activations at their chunk of
# 16,384 spectra (16-byte vectors), two of the entry model's (L 501: one
# float a thread; L 126: 8-byte vectors), a tiny ragged one, and x off
# 16- and 8-byte alignment (one float a thread)
EVAL_CASES = [(16384, 32, 288, True), (16384, 64, 144, True),
              (16384, 128, 72, True), (64, 32, 501, True),
              (64, 128, 126, True), (7, 5, 3, True), (64, 32, 288, False)]


def _eval_operands(nb, nc, nl, aligned, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    flat = torch.randn(nb * nc * nl + 1, generator=gen).mul_(1.5).add_(0.3)
    flat = flat.to(dev)
    x = (flat[:-1] if aligned else flat[1:]).view(nb, nc, nl)
    bias, mean, beta = (torch.randn(nc, generator=gen).mul_(0.4).to(dev)
                        for _ in range(3))
    var, gamma = ((torch.rand(nc, generator=gen) + 0.5).to(dev)
                  for _ in range(2))
    return x, bias, mean, var, gamma, beta


def _ulps(a, b):
    """The largest distance of two float32 tensors in units in the last
    place (same-signed values; exact zeros and sign changes count 0/1)."""
    ia, ib = (t.contiguous().view(torch.int32).long() for t in (a, b))
    return int((ia - ib).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("act", bn.ACTS)
@pytest.mark.parametrize("case", EVAL_CASES, ids=str)
def test_eval_epilogue_kernel_matches_the_eager_chain(cuda, case, act):
    """K9 against the chain it replaces (the conv bias added as torch adds
    it, then ``bn_act_normalize``): bit for bit with ELU and none, within
    2 ulp with exact GELU; in place and into another tensor."""
    x, bias, mean, var, gamma, beta = _eval_operands(*case, cuda)
    assert (x.data_ptr() % 16 == 0) == case[3]
    ref = bn.bn_act_eval_plain(x, bias, mean, var, gamma, beta, 1e-5, act)
    mul = torch.rsqrt(var + 1e-5) * gamma
    before = bn.bn_act_eval.launches
    out = bn.bn_act_eval_fused(x, bias, mean, mul, beta, act,
                               out=torch.empty_like(x))
    inplace = x.clone()
    got = bn.bn_act_eval_fused(inplace, bias, mean, mul, beta, act)
    torch.cuda.synchronize()
    assert got is inplace and bn.bn_act_eval.launches == before + 2
    for a in (out, got):
        if act == "gelu":
            assert _ulps(a, ref) <= 2
        else:
            assert torch.equal(a, ref)


@pytest.mark.cuda
def test_eval_epilogue_rejects_what_it_cannot_take(cuda):
    x, bias, mean, var, gamma, beta = _eval_operands(4, 3, 8, True, cuda)
    with pytest.raises(TypeError, match="float32"):
        bn.bn_act_eval_fused(x.double(), bias, mean, gamma, beta)
    with pytest.raises(ValueError, match="contiguous"):
        bn.bn_act_eval_fused(x.transpose(0, 1), bias, mean, gamma, beta)
    with pytest.raises(ValueError, match="shape"):
        bn.bn_act_eval_fused(x, bias[:2], mean, gamma, beta)
    with pytest.raises(ValueError, match="unknown activation"):
        bn.bn_act_eval_fused(x, bias, mean, gamma, beta, "relu")
    # the wrapper launches or raises on a CUDA tensor: no plain fallback
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        bn.bn_act_eval(strided, bias, mean, var, gamma, beta)
    with pytest.raises(TypeError, match="float32"):
        bn.bn_act_eval(x.double(), bias, mean, var, gamma, beta)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rows", [((16, 32, 288), 3),
                                        ((16, 32, 288), 5),
                                        ((9, 3, 10), 2), ((9, 5, 7), 4)],
                         ids=str)
def test_eval_epilogue_slices_what_one_launch_cannot_index(
        cuda, monkeypatch, shape, rows):
    """With ``K9_MAX_ELEMENTS`` patched to ``rows`` rows and a bit, a batch
    runs as one launch a slice of whole rows (the last one short), with
    one launch's bits, in the 16-, 8- and 4-byte vector builds."""
    x, bias, mean, var, gamma, beta = _eval_operands(*shape, True, cuda)
    ref = bn.bn_act_eval_plain(x, bias, mean, var, gamma, beta, 1e-5, "elu")
    monkeypatch.setattr(bn, "K9_MAX_ELEMENTS", rows * shape[1] * shape[2]
                        + 1)
    before = bn.bn_act_eval.launches
    got = bn.bn_act_eval(x.clone(), bias, mean, var, gamma, beta, 1e-5,
                         "elu")
    torch.cuda.synchronize()
    assert bn.bn_act_eval.launches - before == -(-shape[0] // rows)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_eval_epilogue_past_two_to_the_31_elements(cuda):
    """A batch of more than 2**31 elements (233,018 nuts spectra of 32 x
    288) takes two launches and gives the eager chain's bits throughout."""
    nb = 2**31 // (32 * 288) + 2
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(nb, 32, 288, device=cuda, generator=gen)
    _, bias, mean, var, gamma, beta = _eval_operands(1, 32, 288, True, cuda)
    mul = torch.rsqrt(var + 1e-5) * gamma
    before = bn.bn_act_eval.launches
    out = bn.bn_act_eval_fused(x, bias, mean, mul, beta, "elu",
                               out=torch.empty_like(x))
    assert bn.bn_act_eval.launches - before == 2
    for b0 in range(0, nb, 16384):
        ref = bn.bn_act_eval_plain(x[b0:b0 + 16384], bias, mean, var, gamma,
                                   beta, 1e-5, "elu")
        assert torch.equal(out[b0:b0 + 16384], ref), b0


def _nuts_bundles(dev, n_classes, variant):
    """``n_classes`` nuts-width VAEs (288 bands, latent 16, hidden 128)
    with random weights and BatchNorm statistics, calibrated on 512
    spectra each: (model, bundle, vaesimca model or None), stacked when
    there is more than one class."""
    from ocm_tpu_torch.models.bundle import (new_bundle, spectral_stats,
                                             stack_bundles)

    model = TV.ConvVAE1D(288, 16, hidden_fc=128)
    bundles, fitted = [], []
    for c in range(n_classes):
        gen = torch.Generator().manual_seed(100 + c)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        for k, v in sd.items():
            if v.dtype != torch.float32:
                continue
            if k.endswith("running_var"):
                sd[k] = torch.rand(v.shape, generator=gen) + 0.5
            elif k.endswith("weight"):
                sd[k] = v * (1.0 + 0.2 * torch.rand(v.shape, generator=gen))
            else:
                sd[k] = v + 0.2 * torch.randn(v.shape, generator=gen)
        x_cal = torch.randn(512, 288, generator=gen).to(dev)
        mean, std = spectral_stats(x_cal)
        bundle = new_bundle({k: v.to(dev) for k, v in sd.items()}, mean, std,
                            16)
        if variant == "vaesimca":
            fitted.append(vaesimca.fit_vaesimca(model, bundle, x_cal))
        else:
            bundle = vae_decision.fit_thresholds(model, bundle, x_cal)
        bundles.append(bundle)
    if n_classes == 1:
        return model, bundles[0], fitted[0] if fitted else None
    return (model, stack_bundles(bundles),
            stack_bundles(fitted) if fitted else None)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,classes,epilogues", [
    ("vaesimca", 1, 9), ("d2", 1, 3), ("d2", 5, 15)],
    ids=["vaesimca", "d2", "stacked_d2"])
def test_screens_on_the_eval_kernel_equal_the_plain_path(
        cuda, monkeypatch, variant, classes, epilogues):
    """A 16,384-spectrum screen at the nuts widths gives the same answers,
    bit for bit, with every conv block's epilogue in K9 (counted: all of
    them fused) as with the kernel turned away (all plain)."""
    from ocm_tpu_torch.serving import VAEScorer
    from ocm_tpu_torch.utils import profiling

    model, bundle, vs = _nuts_bundles(cuda, classes, variant)
    scorer = VAEScorer(model, bundle, variant=variant, chunk_size=16384,
                       vaesimca_model=vs)
    x = np.random.default_rng(3).standard_normal((16384, 288)).astype(
        np.float32)
    scorer.score(x)

    def counted():
        profiling.reset()
        with profiling.tracing():
            out = scorer.score(x)
        torch.cuda.synchronize()
        c = profiling.counters()
        profiling.reset()
        return out, (c.get("model.bn_act_eval_fused", 0),
                     c.get("model.bn_act_eval_plain", 0))

    before = bn.bn_act_eval.launches
    fused, counts = counted()
    assert counts == (epilogues, 0)
    assert bn.bn_act_eval.launches == before + epilogues
    monkeypatch.setattr(bn, "eval_kernel_applies", lambda *a: False)
    plain, counts = counted()
    assert counts == (0, epilogues)
    assert fused.keys() == plain.keys()
    for k in fused:
        np.testing.assert_array_equal(fused[k], plain[k], err_msg=k)
