"""Run one cell of the benchmark once and print its result line.

    python3 -m ocm_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  ``BENCHMARK.json`` names the cell; its configuration, traffic mix,
correctness limits and per-layer readers are files found by name:
``ocm_bench/configs/<config>.json``, ``ocm_bench/traffic/<traffic>.json``
(whose ``kind`` names the driver ``ocm_bench/drivers/<kind>.py``),
``ocm_bench/cells/<workload>.json`` and ``ocm_bench/metrics/<metric>.py``.

A run: set-up (imports, CUDA, the driver's data, model, calibration and
warm-up; ``setup_s`` runs from the process's start to the first timed unit
and its split is printed on an earlier line), the measured window of
``--seconds`` (traced by ``torch.profiler`` with ``--trace 1``), the
peak device memory, the import check (no ``jax``, ``jaxlib``, ``flax`` or
``ocm_tpu`` module, by whole top-level name), the program's state freed,
then the comparison with the plain reference (``reference.py``), whose
numbers are printed with their limits as the last lines on standard error
and under ``checks``, the last key of the result line.  The last line on
standard output is the result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ocm_tpu")
HOST_THREADS = 4
CACHE = ROOT / ".bench_cache"


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules (whole
    names: ``ocm_tpu_torch`` is not ``ocm_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def selected(metrics: list, workload: str) -> list:
    """The metrics that ``workload`` reports: those that list it, and
    those with no ``workloads`` key (``setup_s``), which every cell
    reports."""
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything one cell is, read from the manifest and the files it
    names."""
    manifest = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         f"{sorted(work)}")
    w = work[name]
    config = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return {"workload": name, "chips": w["chips"],
            "cfg": load_json(root / config["file"]),
            "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(HERE / "cells" / f"{name}.json")["limits"],
            "end_to_end": selected(manifest["end_to_end"], name),
            "per_layer": selected(manifest["per_layer"], name)}


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"ocm_bench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Marks:
    """The split of set-up: seconds from the previous mark to each."""

    def __init__(self, t0: float):
        self.last, self.split = t0, {}

    def __call__(self, name: str):
        now = time.perf_counter()
        self.split[name] = self.split.get(name, 0.0) + now - self.last
        self.last = now


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell: dict, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", t0: float | None = None,
             log=None) -> dict:
    """One run of ``cell`` (``load_cell``'s dict); returns the result
    line's object.  ``device`` 'cpu' runs the same path on the CPU (the
    harness's tests)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    marks = Marks(_T0 if t0 is None else t0)
    import torch
    marks("import_torch")
    torch.set_num_threads(HOST_THREADS)
    on_card = device != "cpu"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.reset_peak_memory_stats()
    marks("cuda_init")

    drv = importlib.import_module(
        f"ocm_bench.drivers.{cell['traffic']['kind']}")
    ctx = {"cfg": cell["cfg"], "traffic": cell["traffic"], "seed": seed,
           "device": device, "mark": marks, "log": log,
           "limits": cell["limits"]}
    state = drv.setup(ctx)
    setup_s = time.perf_counter() - (_T0 if t0 is None else t0)
    log("setup_split " + json.dumps({k: round(v, 4) for k, v in
                                     marks.split.items()}))

    prof = None
    if trace_on:
        from torch.profiler import ProfilerActivity, profile, record_function

        from ocm_bench import trace
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.start()
        with record_function(trace.WINDOW):
            record = drv.window(ctx, state, seconds)
        if on_card:
            torch.cuda.synchronize()
        prof.stop()
    else:
        record = drv.window(ctx, state, seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")

    kept = drv.release(state)
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    if trace_on:
        tr = trace.from_profiler(prof)
        del prof
        rctx = {"cfg": cell["cfg"], "traffic": cell["traffic"], "trace": tr,
                "counts": record["counts"]}
        metrics = {}
        for m in cell["per_layer"]:
            value = reader(m["name"])(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(drv.end_to_end(ctx, record), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}

    numbers = drv.check(ctx, kept, record)
    limits = cell["limits"]
    checks = {k: {"value": _finite(v), "limit": limits[k]}
              for k, v in numbers.items()}
    correct = all(_finite(v) is not None and v <= limits[k]
                  for k, v in numbers.items())

    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics}
    if on_card:
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell["chips"], "memory_peak_bytes": int(peak)}
        log(f"card {power_limit()}")
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if trace_on:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    times = sorted(record["unit_times"])
    log(f"window {record['t_end'] - record['t0']:.4f} s, "
        f"{record['attempted']} {drv.UNIT}s, counts {record['counts']}, "
        f"seconds a call: min {times[0]:.5f} median "
        f"{times[len(times) // 2]:.5f} max {times[-1]:.5f}")
    for k, c in checks.items():
        log(f"check {k} {numbers[k]!r} limit {c['limit']!r}")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.makedirs(CACHE / sub, exist_ok=True)
        os.environ[var] = str(CACHE / sub)
    # the bytecode of every later import (torch's above all) is cached in
    # the checkout, also where PYTHONDONTWRITEBYTECODE is set, so that only
    # a checkout's first run compiles it
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
