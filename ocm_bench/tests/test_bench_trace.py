"""The trace reduction on a synthetic event list."""

import pytest

from ocm_bench import trace


class Ev:
    def __init__(self, kind, name, start, dur, device="CPU"):
        self.kind, self._name, self.s, self.d = kind, name, start, dur

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d


def synthetic():
    return trace.from_events([
        Ev("user_annotation", trace.WINDOW, 1000, 10_000),
        Ev("cpu_op", "aten::conv1d", 900, 3000),        # covers gap 1
        Ev("cpu_op", "aten::copy_", 6000, 1000),          # covers gap 2
        Ev("kernel", "k_outside", 0, 1500),               # clipped to 500
        Ev("kernel", "k_a", 4000, 1000),
        Ev("kernel", "k_a", 4500, 1000),                  # overlaps: union
        Ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 8000, 500),
        Ev("cuda_runtime", "cudaLaunchKernel", 3900, 10),
        Ev("gpu_user_annotation", trace.WINDOW, 1000, 10_000),
    ])


def test_window_busy_and_idle():
    tr = synthetic()
    assert tr.window_s == pytest.approx(10e-6)
    # busy: [1000, 1500] + [4000, 5500] + [8000, 8500] = 2500 ns
    assert tr.busy_s() == pytest.approx(2.5e-6)
    assert tr.idle_pct() == pytest.approx(75.0)


def test_copies_launches_and_breakdown():
    tr = synthetic()
    assert tr.device_seconds(trace.COPY, "HtoD") == pytest.approx((5e-7, 1))
    assert tr.device_seconds(trace.RUNTIME, "LaunchKernel")[1] == 1
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(2e-6)]
    idle = dict((n, v) for n, v in b["idle_gaps"])
    # gaps [1500, 4000] (mid 2750: conv1d), [5500, 8000] (mid 6750:
    # copy_), [8500, 11000] (mid 9750: nothing: python)
    assert idle == {"aten::conv1d": pytest.approx(2.5e-6),
                    "aten::copy_": pytest.approx(2.5e-6),
                    "python": pytest.approx(2.5e-6)}


def test_device_idle_reader_and_empty_trace():
    from ocm_bench import run

    read = run.reader("device_idle_pct.screen")
    assert read({"trace": synthetic(), "counts": {}}) == pytest.approx(75.0)
    assert read({"trace": trace.Trace(), "counts": {}}) is None
    h2d = run.reader("h2d_ms.screen")
    assert h2d({"trace": synthetic(), "counts": {"frames": 2}}) == \
        pytest.approx(2.5e-4)
    assert h2d({"trace": trace.Trace(), "counts": {"frames": 2}}) is None
    mfu = run.reader("mfu.screen")
    assert mfu({"trace": trace.Trace(), "counts": {"spectra": 8}}) is None


def test_events_without_activity_type():
    class Old:
        def __init__(self, name, device, s, d):
            self.n, self.dev, self.s, self.d = name, device, s, d

        def name(self):
            return self.n

        def device_type(self):
            return f"DeviceType.{self.dev}"

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d

    tr = trace.from_events([Old(trace.WINDOW, "CPU", 0, 100),
                            Old(trace.WINDOW, "CUDA", 0, 100),
                            Old("void k<1>()", "CUDA", 10, 20),
                            Old("Memset (Device)", "CUDA", 40, 10),
                            Old("cudaLaunchKernel", "CPU", 5, 2),
                            Old("cuLaunchKernelEx", "CPU", 6, 2),
                            Old("aten::add", "CPU", 5, 40)])
    assert tr.busy_s() == pytest.approx(30e-9)
    assert tr.device_seconds(trace.RUNTIME, "LaunchKernel")[1] == 2
