"""``ocm_tpu_torch.config`` and the float64 rule of ``_device`` (fault F1:
float64 input bound for the card).

On CUDA the port computes in float32, the counterpart of the JAX
package's x64-off accelerator (``ocm_tpu/config.py``'s ``stats_dtype``);
on the CPU in float64, as the parity tests against JAX x64 need.  Float64
host data bound for CUDA with no ``dtype=`` becomes float32; an explicit
float64 request on CUDA raises ``ValueError`` at an entry point that
launches an f32-only kernel.  The rule is checked here with
``torch.device("cuda")`` as an argument, without allocating on it;
``test_torch_port_package.py``'s card-only
``test_float64_numpy_runs_in_float32_on_the_card`` feeds float64 numpy
through the kernels on a card.
"""

import numpy as np
import pytest
import torch

from ocm_tpu import config as jconfig
from ocm_tpu_torch import config
from ocm_tpu_torch._device import require_f32, target_dtype
from ocm_tpu_torch.models import trainer
from ocm_tpu_torch.utils import profiling

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def test_stats_dtype_follows_the_device():
    assert config.stats_dtype(CUDA) == torch.float32
    assert config.stats_dtype("cuda:0") == torch.float32
    assert config.stats_dtype(CPU) == torch.float64
    assert config.stats_dtype("cpu") == torch.float64
    # the JAX package's counterpart under the tests' x64
    assert np.dtype(jconfig.stats_dtype()) == np.float64


@pytest.mark.parametrize("x,dtype,want", [
    (np.zeros(3), None, torch.float32),
    (np.zeros(3, np.float32), None, None),
    (np.zeros(3, np.int64), None, None),
    ([0.5, 1.5], None, torch.float32),
    ([1, 2], None, None),
    (torch.zeros(3, dtype=torch.float64), None, torch.float32),
    (torch.zeros(3, dtype=torch.bfloat16), None, None),
    (torch.zeros(3, dtype=torch.int8), None, None),
    (np.zeros(3), torch.float64, torch.float64),
    (np.zeros(3, np.float32), torch.float64, torch.float64),
], ids=["np64", "np32", "int", "list_float", "list_int", "cpu64", "bf16",
        "int8", "explicit64", "explicit64_from32"])
def test_host_float64_bound_for_cuda_becomes_float32(x, dtype, want):
    assert target_dtype(x, CUDA, dtype) == want


@pytest.mark.parametrize("x", [np.zeros(3),
                               torch.zeros(3, dtype=torch.float64),
                               np.zeros(3, np.float32)],
                         ids=["np64", "cpu64", "np32"])
def test_the_cpu_keeps_every_dtype(x):
    assert target_dtype(x, CPU) is None
    assert target_dtype(x, CPU, torch.float64) == torch.float64


def test_require_f32_names_the_kernel():
    with pytest.raises(ValueError, match="fit_simca: float64 on CUDA.*K1"):
        require_f32(torch.float64, CUDA, "kernel K1", "fit_simca")
    for dtype, dev in ((torch.float32, CUDA), (torch.float64, CPU),
                       (torch.bfloat16, CUDA)):
        require_f32(dtype, dev, "kernel K1", "fit_simca")


def test_training_dtype_follows_the_device():
    x64, x32 = np.zeros((4, 3)), np.zeros((4, 3), np.float32)
    assert trainer._dtype_of(x64, CUDA) == torch.float32
    assert trainer._dtype_of(torch.from_numpy(x64), CUDA) == torch.float32
    assert trainer._dtype_of(x32, CUDA) == torch.float32
    assert trainer._dtype_of(x64, CPU) == torch.float64
    assert trainer._dtype_of(x32, CPU) == torch.float32
    assert trainer._dtype_of(np.zeros((4, 3), np.float16), CPU) \
        == torch.float32


def test_compat_flags_and_debug_nans():
    assert config.DEFAULT_COMPAT == config.CompatFlags()
    assert (config.DEFAULT_COMPAT.batch_qhf_stats
            and config.DEFAULT_COMPAT.testset_f_moments
            and config.DEFAULT_COMPAT.vaesimca_percentile_limits)
    assert [f for f in config.CompatFlags.__dataclass_fields__] == [
        f for f in jconfig.CompatFlags.__dataclass_fields__]
    assert config.debug_nans is profiling.debug_nans
    assert not hasattr(config, "enable_x64")
    assert not hasattr(config, "x64_enabled")


def test_cpu_float64_is_unchanged():
    """On the CPU the entry points keep float64 (the parity tests' mode)."""
    from ocm_tpu_torch.models.simca import fit_simca, predict_classes
    from ocm_tpu_torch.models.streaming import moments_from

    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 12))
    m = fit_simca(x, 3, device="cpu")
    assert m.mean.dtype == torch.float64
    assert predict_classes(m, x)[1].dtype == torch.float64
    assert moments_from(x, device="cpu").mean.dtype == torch.float64
