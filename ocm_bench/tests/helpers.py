"""Small cells for the harness's CPU tests: the manifest's cells with
their widths and counts cut so that a run takes seconds on the CPU."""

from __future__ import annotations

from ocm_bench import run


def small_cell(workload: str) -> dict:
    cell = run.load_cell(workload)
    cell["cfg"].update(frame_spectra=512, chunk_size=256,
                       calibration_spectra=128)
    cell["traffic"]["pool_frames"] = 2
    return cell


def cpu_run(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 0.05,
            trace: bool = False, cell: dict | None = None) -> dict:
    return run.run_cell(cell or small_cell(workload), seed, seconds, trace,
                        device="cpu", log=lambda *a: None)
