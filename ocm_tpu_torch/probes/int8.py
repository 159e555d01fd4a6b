"""The int8 serving tier's probe on the card: how fast do kernels K7 (read
int8 tiles and sum them) and K8 (s8 x s8 -> s32 product, reduced per tile)
stream int8 spectra?

Port of ``scripts/probe_pallas_int8.py``: the same seeded inputs (numpy
``default_rng(0)``: xq (98,304, 512) int8, wq (512, 128) int8; ``--small``
(1,024, 128) at tile 256) and the same tiles (512, 1,024, 2,048).  Each
kernel is first held against its plain twin (integer equality), then
timed on the device beside its PyTorch yardstick: ``xq.view(T, -1).sum(1,
dtype=torch.int32)`` for the read, ``torch._int_mm`` for the product.

The input (50.3 MB) is about the size of the card's 50 MB L2, so calls
rotate over ``BUFFERS`` distinct copies of it (>= 200 MB), each a
perturbed draw, and each call reads its input from device memory, as a
screen would.

    python -m ocm_tpu_torch.probes.int8 [--small] [--repeats 5]

Prints one line a kernel (device ms and effective GB/s of the int8 read)
and a JSON line with every number.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from ocm_tpu_torch.ops import kernels

HEADLINE = (98304, 512, (512, 1024, 2048))
SMALL = (1024, 128, (256,))
COLUMNS = 128
BUFFERS = 5


def make_inputs(n: int, lp: int, device="cpu"):
    """The JAX probe's draws: ``default_rng(0)``, xq (n, lp) then wq (lp,
    128), int8 in [-127, 127]; returns (xq, wq) tensors on ``device``."""
    rng = np.random.default_rng(0)
    xq = rng.integers(-127, 128, (n, lp), dtype=np.int8)
    wq = rng.integers(-127, 128, (lp, COLUMNS), dtype=np.int8)
    return (torch.from_numpy(xq).to(device), torch.from_numpy(wq).to(device))


def rotated(xq, count: int = BUFFERS):
    """``count`` distinct copies of ``xq``, copy i with its first row
    xor-ed by i (as the JAX probe perturbs a row a step)."""
    out = []
    for i in range(count):
        b = xq.clone()
        b[0] ^= i
        out.append(b)
    return out


def device_ms(fn, inputs, reps: int = 40) -> float:
    """Device time of one ``fn(x)`` in ms, ``x`` rotating over ``inputs``:
    the calls are queued behind a GPU sleep that outlasts their host-side
    enqueue, so the events time the kernels back to back."""
    import time

    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2e6 * (2 * host_ms + 1)))
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check(xq, w, tiles):
    """Every kernel against its plain twin on ``xq``; raises on the first
    disagreement.  Returns the launch-free twin totals."""
    for tile in tiles:
        got = kernels.int8_tile_sum(xq, tile)
        if not torch.equal(got, kernels.int8_tile_sum_plain(xq, tile)):
            raise RuntimeError(f"K7 at tile {tile} differs from its twin")
        got = kernels.int8_gemm_s32(xq, w, tile)
        if not torch.equal(got, kernels.int8_gemm_s32_plain(xq, w, tile)):
            raise RuntimeError(f"K8 at tile {tile} differs from its twin")


def scan(xq, w, tiles) -> dict:
    """The probe's measured work, once: for each tile, K7's tile sums and
    K8's per-tile column sums of ``xq`` against ``w`` (M, L), each reduced
    to one int64 total, as the JAX probe sums each kernel's output."""
    out = {}
    for tile in tiles:
        out[f"read t={tile}"] = int(kernels.int8_tile_sum(xq, tile).sum(
            dtype=torch.int64))
        out[f"gemm t={tile}"] = int(kernels.int8_gemm_s32(xq, w, tile).sum(
            dtype=torch.int64))
    return out


def run(small: bool = False, repeats: int = 5, reps: int = 40) -> dict:
    """Check and time K7 and K8 at the probe's shapes; returns
    {name: {"ms": median device ms, "gb_s": effective GB/s}}."""
    if not torch.cuda.is_available():
        raise RuntimeError("the int8 probe times kernels on a CUDA card; "
                           "torch.cuda.is_available() is False")
    n, lp, tiles = SMALL if small else HEADLINE
    xq, wq = make_inputs(n, lp, "cuda")
    w = wq.T.contiguous()                    # K8 takes (M, L)
    check(xq, w, tiles)
    inputs = rotated(xq, BUFFERS)
    gb = xq.numel() / 1e9
    # torch._int_mm needs K and N multiples of 8 and more than 16 rows
    cases = {"torch read": lambda x: x.view(n // tiles[0], -1).sum(
                 1, dtype=torch.int32),
             "torch _int_mm": lambda x: torch._int_mm(x, wq)}
    for tile in tiles:
        cases[f"read t={tile}"] = lambda x, t=tile: kernels.int8_tile_sum(x, t)
    for tile in tiles:
        cases[f"gemm t={tile}"] = (
            lambda x, t=tile: kernels.int8_gemm_s32(x, w, t))
    out = {}
    for name, fn in cases.items():
        ms = statistics.median(device_ms(fn, inputs, reps)
                               for _ in range(repeats))
        out[name] = {"ms": ms, "gb_s": gb / (ms / 1e3)}
        print(f"{name:16s} {ms:8.4f} ms   {out[name]['gb_s']:7.1f} GB/s "
              "effective", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8 probe: needs a CUDA card", file=sys.stderr)
        return 1
    print("device:", torch.cuda.get_device_name(0), flush=True)
    print(json.dumps({"int8_probe": run(args.small, args.repeats)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
