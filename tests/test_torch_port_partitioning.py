"""The collectives and shards of every ``ocm_tpu_torch.parallel`` entry
point, read from the mesh's records (``Mesh.recording``, the counterpart
of the compiled HLO that ``tests/test_partitioning.py`` inspects), on
gloo groups of 4 ranks (``torch_port_dist_util.RankPool``).

The properties are ``tests/test_partitioning.py``'s, at its shapes:

- the expected collectives exist (all-reduces of the class statistics,
  gathers of the per-sample train statistics);
- embarrassingly parallel axes issue no reduction: scoring none at all,
  the fold-sharded sweeps and the config sweeps only the gathers of their
  outputs;
- each rank holds 1/n of the rows (or folds) it is sharded over;
- the budgets hold: the fit's all-reduce payload is its statistics, O(L^2)
  bytes independent of N (4 (L^2 + L + 1 + k^2 + k) = 676 B at L 12, k 3
  in f32), the streaming ingest's 8 (L^2 + L + 1) in f64 in at most 2
  rounds, the 2-D sweep's 4 (F/m) (L^2 + L + 1) + 64 in at most 3 rounds,
  the data-parallel step's 4 n_param + 400 in at most 9 rounds.

Every all-reduce is one round here (no combiner merges them), so an extra
reduction, dependent or not, trips both the round and the payload budget
(``test_extra_psum_trips_budget``).
"""

import re

import numpy as np
import pytest
import torch

import torch_port_dist_util as U

D1 = ((4,), ("data",))
M1 = ((4,), ("model",))
MD = ((2, 2), ("model", "data"))


@pytest.fixture(scope="module")
def pool():
    p = U.RankPool(4)
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cls_data(n=16, length=12, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, length)
    return (rng.normal(1, 0.08, (n, 1)) * np.sin(2 * np.pi * 3 * t)
            + rng.normal(0, 0.02, (n, length))).astype(np.float32)


def _ops(sink, op):
    return [r for r in sink if r.startswith(op + " ")]


def rounds(sink, op="all-reduce") -> int:
    return len(_ops(sink, op))


def payload(sink, op="all-reduce") -> int:
    return sum(int(re.search(r"bytes=(\d+)", r).group(1))
               for r in _ops(sink, op))


def shard(sink, what) -> tuple:
    """(local, global) shapes of the sharded input ``what``."""
    (rec,) = [r for r in sink if r.startswith("shard ")
              and f" what={what} " in r]
    local, glob = re.search(r"local=(\(.*?\)) global=(\(.*?\))", rec).groups()
    return eval(local), eval(glob)


def test_fit_simca_sharded_partitions_and_reduces(pool):
    """The sample axis split 4 ways ((4, 12) rows a rank), the statistics
    all-reduced in 4 rounds carrying exactly 676 B, the per-sample train
    statistics gathered once."""
    x = _cls_data()
    for model, sink in pool.run(U.job_fit, *D1, x, np.ones(16, np.float32),
                                3, {}):
        assert shard(sink, "x") == ((4, 12), (16, 12))
        assert shard(sink, "w") == ((4,), (16,))
        assert rounds(sink) == 4
        assert payload(sink) == 4 * (12 * 12 + 12 + 1 + 3 * 3 + 3) == 676
        assert 1 <= rounds(sink, "all-gather") <= 3
        assert model["mean"].dtype == np.float32


def test_predict_sharded_is_collective_free(pool):
    from ocm_tpu_torch.models.simca import fit_simca, simca_model_to_numpy

    model = simca_model_to_numpy(fit_simca(_cls_data(24, 12), 3,
                                           device="cpu"))
    for out, sink in pool.run(U.job_predict, *D1, model,
                              _cls_data(16, 12, seed=1), "alt"):
        assert [r for r in sink if not r.startswith("shard ")] == []
        assert shard(sink, "x") == ((4, 12), (16, 12))
        assert out[1].shape == (4,)


def test_moments_ingest_partitions_batch(pool):
    """Two rounds (count and sum, then the scatter) carrying exactly
    8 (L^2 + L + 1) = 1256 B in f64; (4, 12) rows a rank."""
    x = _cls_data().astype(np.float64)
    for _, sink in pool.run(U.job_moments, *D1, 12, [(x, None)]):
        assert shard(sink, "x") == ((4, 12), (16, 12))
        assert rounds(sink) <= 2
        assert payload(sink) <= 8 * (12 * 12 + 12 + 1)
        assert rounds(sink, "all-gather") == 0


@pytest.mark.parametrize("fn", ["cv_sweep_sharded",
                                "cv_sweep_sharded_multiclass"])
def test_cv_sweep_fold_axis_partitioned(pool, fn):
    """Fold (or class x fold) fits are independent: 5 folds pad to 8 (2
    classes x 4 folds are 8 units), 2 a rank, and the only collectives
    gather the decisions and fold specificities."""
    x = _cls_data(20, 12)
    y = np.array([0] * 10 + [1] * 10)
    args = ((x, y, 0, [2, 3]) if fn == "cv_sweep_sharded"
            else (x, y, [0, 1], [2, 3]))
    kw = {"n_splits": 5 if fn == "cv_sweep_sharded" else 4}
    for out, sink in pool.run(U.job_cv, *M1, fn, args, kw):
        assert np.isfinite(np.asarray(out["spec"])).all()
        assert shard(sink, "train") == ((2, 20), (8, 20))
        assert rounds(sink) == 0
        assert {re.search(r"what=(\S+)", r).group(1)
                for r in _ops(sink, "all-gather")} == {"accept", "spec"}


def test_cv_sweep_2d_both_axes_partitioned(pool):
    """Folds over the model axis and samples over the data axis of a
    (2, 2) mesh: x is (10, 12) a rank, the fold masks (2, 10); the class
    statistics and counts all-reduce over the data axis in 3 rounds within
    4 (F/m) (L^2 + L + 1) + 64 B; the train statistics gather over it."""
    x = _cls_data(20, 12)
    y = np.array([0] * 10 + [1] * 10)
    for out, sink in pool.run(U.job_cv, *MD, "cv_sweep_sharded_2d",
                              (x, y, 0, [2, 3]), {"n_splits": 4}):
        assert np.isfinite(out["spec"]).all()
        assert shard(sink, "x") == ((10, 12), (20, 12))
        assert shard(sink, "train") == ((2, 10), (4, 20))
        assert all("axis=data" in r for r in _ops(sink, "all-reduce"))
        assert rounds(sink) <= 3
        assert payload(sink) <= 4 * 2 * (12 * 12 + 12 + 1) + 64
        assert any("what=t2+q+w" in r for r in _ops(sink, "all-gather"))


def test_sharded_config_sweep_partitions_configs(pool):
    """24 configs, 6 a rank: the epoch loop reduces nothing; the only
    collectives gather the train results (24 rows)."""
    x_cal, x_val = _cls_data(16, 32), _cls_data(8, 32, seed=1)
    arch = dict(input_length=32, latent_dim=2, conv_blocks=2, n_filters=4,
                hidden_fc=16)
    for sink in pool.run(U.job_sweep_records, *M1, arch, x_cal, x_val, 24):
        assert rounds(sink) == 0
        gathers = _ops(sink, "all-gather")
        assert gathers and all("what=train result" in r for r in gathers)
        assert all(re.search(r"shape=\(24, ", r) for r in gathers)


def test_dp_train_step_partitions_batch_and_reduces_grads(pool):
    """The batch split 4 ways; 4 BatchNorm layers all-reduce their
    statistics forward and their cotangents backward, the gradients, loss
    and count go in one more round: 9 rounds within 4 n_param + 400 B."""
    xb = _cls_data(16, 32)
    eps = np.random.default_rng(2).normal(size=(16, 2)).astype(np.float32)
    arch = dict(input_length=32, latent_dim=2, conv_blocks=2, n_filters=4,
                hidden_fc=16)
    for sink, n_param in pool.run(U.job_dp_records, *D1, arch, xb, eps):
        assert rounds(sink) <= 9
        assert 4 * n_param < payload(sink) <= 4 * n_param + 400
        assert sum("what=bn stats" in r for r in sink) == 8


def test_extra_psum_trips_budget(pool):
    """The budget catches pollution: a twin of the streaming ingest's
    collectives within its budget (<= 2 rounds, <= 8 (L^2 + L + 1) B), and
    with one extra reduction, dependent or independent, over both."""
    x = _cls_data().astype(np.float64)
    budget_rounds, budget_bytes = 2, 8 * (12 * 12 + 12 + 1)
    clean = pool.run(U.job_polluted_ingest, *D1, x, "none")[0]
    assert rounds(clean) <= budget_rounds
    assert payload(clean) <= budget_bytes
    for extra in ("dependent", "independent"):
        sink = pool.run(U.job_polluted_ingest, *D1, x, extra)[0]
        assert rounds(sink) > budget_rounds
        assert payload(sink) > budget_bytes
