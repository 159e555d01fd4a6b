"""Package rules of the port: it imports neither JAX nor ``ocm_tpu``, it
never runs quietly on the CPU when CUDA was (implicitly) asked for, and
its kernel wrapper counts only real kernel launches.  The kernel-vs-twin
tests need a CUDA card and skip without one."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ocm_tpu_torch.models import simca as TS
from ocm_tpu_torch.ops import kernels

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ocm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_no_jax():
    code = ("import sys, ocm_tpu_torch, ocm_tpu_torch.models.simca, "
            "ocm_tpu_torch.ops.kernels, ocm_tpu_torch.ops._build; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'ocm_tpu' or m.startswith('ocm_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
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
            assert top not in ("jax", "jaxlib", "flax", "ocm_tpu"), (path, name)


def test_numpy_input_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    x = np.random.default_rng(0).normal(size=(30, 12))
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.fit_simca(x, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.simca_model_from_numpy({})


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


def test_non_cpu_non_cuda_tensor_raises():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.t2q_scores_multiclass(x, x[:1], x[None, :1], x[None, :1, :1])


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


# (N, L, C, k, aligned): the bench's shapes cut in N, a ragged single
# class, three class groups with chunks of L, k > 32 (two passes of loading
# rows) with L not a multiple of 4, k = 1 (18 classes to a group) with C 20,
# k = 33 (a one-row second pass), and x rows off 16-byte alignment (scalar
# staging although L is a multiple of 4)
KERNEL_CASES = [(4096, 500, 3, 10, True), (137, 96, 1, 8, True),
                (1000, 2000, 5, 12, True), (300, 203, 2, 40, True),
                (500, 64, 20, 1, True), (200, 100, 2, 33, True),
                (257, 96, 2, 5, False)]


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


@pytest.mark.cuda
def test_kernel_rejects_float64(cuda):
    x = torch.zeros(8, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        kernels.t2q_scores_multiclass(x, x[:1], x[None, :1], x[None, :1, :1])
