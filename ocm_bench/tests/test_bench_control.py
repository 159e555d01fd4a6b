"""The control on the card: the reference computed in TF32, put in the
program's place, fails the comparison; the program passes it.  At a size
a test run holds (one frame of 512 spectra a screen)."""

import pytest

from ocm_bench import control
from ocm_bench.tests.helpers import small_cell

CELLS = ["nuts_swir.vae_camera", "nuts_swir.vae_camera_d2",
         "nuts_swir.vae_sort_d2"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32, the control's precision, "
                    "exists only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload, card):
    cell = small_cell(workload)
    limits = cell["limits"]
    for seed in (11, 12, 13):
        ctl = control.readings(cell, seed, 0.5, card, control=True)
        assert any(v > limits[k] for k, v in ctl.items()), ctl
        prog = control.readings(cell, seed, 0.5, card)
        assert all(v <= limits[k] for k, v in prog.items()), prog
