"""Whole runs of every cell on the CPU at small sizes: the result line's
keys, a correct run, and what the run imports."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from ocm_bench import run
from ocm_bench.tests.helpers import cpu_run

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = [w["name"] for w in
             json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(workload, trace):
    res = cpu_run(workload, trace=trace)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    cell = run.load_cell(workload)
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    else:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "window_s" in res["device"]


def test_the_seed_fixes_the_inputs():
    from ocm_bench import data
    cell = run.load_cell("nuts_swir.vae_camera")
    cfg, traffic = cell["cfg"], cell["traffic"]
    cfg["frame_spectra"], traffic["pool_frames"] = 64, 2
    a = data.frame_pool(cfg, traffic, 2 ** 32 + 5, "cpu")
    b = data.frame_pool(cfg, traffic, 2 ** 32 + 5, "cpu")
    assert all((x == y).all() for x, y in zip(a, b))
    order = data.frame_order(11, 8, 24)
    assert sorted(order[:8]) == list(range(8))


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from ocm_bench.tests.helpers import cpu_run\n"
        "for w in %r: cpu_run(w, trace=True)\n"
        "from ocm_bench import run\n"
        "print(run.forbidden_modules())\n"
        "print('ocm_tpu_torch' in sys.modules)\n" % (str(ROOT), WORKLOADS))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["[]", "True"]


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ocm_tpu_torchlike", sys)
    assert "ocm_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ocm_tpu.models", sys)
    assert "ocm_tpu" in run.forbidden_modules()


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "data.py", "compare.py", "flops.py"):
        found = _imports(ROOT / "ocm_bench" / name)
        assert found <= {"__future__", "contextlib", "math", "statistics",
                         "numpy", "torch", "ocm_bench"}, (name, found)


def test_no_file_of_the_benchmark_imports_jax():
    for path in (ROOT / "ocm_bench").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "ocm_tpu"}, path


def test_no_card_exits_without_a_result():
    out = subprocess.run(
        [sys.executable, "-m", "ocm_bench.run", "--workload",
         "nuts_swir.vae_camera", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT / ".bench_cache")})
    assert out.returncode != 0 and out.stdout.strip() == ""
