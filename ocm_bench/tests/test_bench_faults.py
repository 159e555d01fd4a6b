"""A run whose timed path is broken underneath comes out not correct:
each fault that a cell can have, planted in the program on the CPU."""

import numpy as np
import pytest

from ocm_bench.tests.helpers import cpu_run

SCREENS = ["nuts_swir.vae_camera", "nuts_swir.vae_camera_d2",
           "nuts_swir.vae_sort_d2"]


@pytest.mark.parametrize("workload", SCREENS)
def test_screen_answer_altered(workload, monkeypatch):
    from ocm_tpu_torch import serving

    fetch = serving._ChunkedScorer._fetch

    def altered(self, res, n):
        out = fetch(self, res, n)
        out["accept"][:16] = ~out["accept"][:16]
        return out

    monkeypatch.setattr(serving._ChunkedScorer, "_fetch", altered)
    res = cpu_run(workload)
    assert not res["correct"]
    assert res["checks"]["decision_flips"]["value"] > 0


@pytest.mark.parametrize("workload", SCREENS)
def test_screen_statistic_altered(workload, monkeypatch):
    from ocm_tpu_torch import serving

    fetch = serving._ChunkedScorer._fetch
    key = "t2" if workload.endswith("camera") else "d2"

    def altered(self, res, n):
        out = fetch(self, res, n)
        out[key][3] *= 1.001
        return out

    monkeypatch.setattr(serving._ChunkedScorer, "_fetch", altered)
    res = cpu_run(workload)
    assert not res["correct"]
    assert res["checks"]["stat_gap"]["value"] > res["checks"]["stat_gap"]["limit"]


@pytest.mark.parametrize("workload", SCREENS)
def test_screen_half_the_chunk_left_out(workload, monkeypatch):
    from ocm_tpu_torch import serving

    prepare = serving.VAEScorer._prepare_chunk

    def half(self, chunk):
        h = chunk.shape[0] // 2
        return prepare(self, np.concatenate([chunk[:h], chunk[:h]]))

    monkeypatch.setattr(serving.VAEScorer, "_prepare_chunk", half)
    assert not cpu_run(workload)["correct"]
