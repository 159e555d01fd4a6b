"""The port's int8 tier against ``ocm_tpu``: ``quantize_rows_int8``,
``t2_q_scores_multiclass_int8`` and ``predict_classes_int8``, and the plain
twins of kernels K7 (``int8_tile_sum``) and K8 (``int8_gemm_s32``).

The quantization is bit-equal to JAX's (same f32 arithmetic); the int8
product is exact in both packages, so the statistics agree to f32 rounding
of the epilogue (1e-5 of scale) and the accepts are equal.

K7 and K8 port the int8 probe's Pallas kernels (``make_read`` and
``make_gemm`` in ``scripts/probe_pallas_int8.py``). Those kernels are
closures inside the script's ``main()``, so they cannot be called from a
test; the reachable reference is what the probe checks them with, its XLA
baselines ``jnp.sum(xb.astype(int32))`` and the summed ``dot_general``
(``probe_pallas_int8.py:120-123``, here without the ``% 997``), at the
probe's ``--small`` shapes. Per tile, the twins are held to numpy by
integer equality. The kernels themselves are held to the twins on the
card (``test_torch_port_package.py``, marker ``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.models import simca as JS
from ocm_tpu.ops import linalg as JL
from ocm_tpu_torch.models import simca as TS
from ocm_tpu_torch.ops import kernels
from ocm_tpu_torch.ops import linalg as TL
from ocm_tpu_torch.probes import int8 as probe
from torch_port_data import LENGTH, make_data, simca_classes_pair


def _rows(seed=0, n=40, length=LENGTH):
    """f32 rows of mixed scale, with all-zero rows and exact ties."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(0, 1, (n, length))
         * 10.0 ** rng.uniform(-4, 3, (n, 1))).astype(np.float32)
    a[3] = 0.0
    a[7, :] = 0.0
    a[7, 5] = -2.5e-3                          # one nonzero entry
    a[11] = np.arange(length, dtype=np.float32) - length / 2   # x.5 ties
    a[11, 0] = 127.0
    return a


def test_quantize_numpy_bit_equal_to_jax():
    a = _rows()
    got, ref = TL.quantize_rows_int8(a), JL.quantize_rows_int8(a)
    for g, r, dt in zip(got, ref, (np.int8, np.float32, np.float32)):
        assert isinstance(g, np.ndarray) and g.dtype == dt
        np.testing.assert_array_equal(g, np.asarray(r))
    q, scale, sumsq = got
    assert np.all(q[3] == 0) and np.isfinite(scale).all() and sumsq[3] == 0
    assert np.abs(q).max() == 127


def test_quantize_torch_bit_equal_to_numpy():
    a = _rows(seed=1)
    want = TL.quantize_rows_int8(a)
    got = TL.quantize_rows_int8(torch.from_numpy(a))
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w)
    # the device-side form of JAX's own quantization (jnp branch)
    ref = JL.quantize_rows_int8(jnp.asarray(a))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.fixture(scope="module")
def models():
    cals, xs = make_data(seed=2)
    ref, port = simca_classes_pair(cals.reshape(-1, LENGTH).astype(np.float32))
    center = np.mean(np.asarray(ref.mean), axis=0).astype(np.float32)
    return ref, port, xs.astype(np.float32), center


def _scale_close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def test_t2q_int8_matches_jax(models):
    ref, port, xs, center = models
    xq, x_scale, x_sumsq = TL.quantize_rows_int8(xs - center)
    t2, q, t = TL.t2_q_scores_multiclass_int8(
        torch.from_numpy(xq), torch.from_numpy(x_scale),
        torch.from_numpy(x_sumsq), port.mean, port.components, port.invcovT,
        x_offset=torch.from_numpy(center))
    t2_r, q_r, t_r = JL.t2_q_scores_multiclass_int8(
        jnp.asarray(xq), jnp.asarray(x_scale), jnp.asarray(x_sumsq),
        ref.mean, ref.components, ref.invcovT, x_offset=jnp.asarray(center))
    assert t2.dtype == torch.float32 and t2.shape == (3, xs.shape[0])
    _scale_close(t2, t2_r)
    _scale_close(q, q_r)
    _scale_close(t, t_r)


def test_predict_classes_int8_matches_jax(models):
    ref, port, xs, center = models
    prep = TL.quantize_rows_int8(xs - center)
    acc, dred, t2, q = TS.predict_classes_int8(port, *prep,
                                               x_offset=center)
    acc_r, dred_r, _, _ = JS.predict_classes_int8(
        ref, *(jnp.asarray(a) for a in prep), x_offset=jnp.asarray(center))
    assert acc.shape == (3, xs.shape[0]) and acc.dtype == torch.bool
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_r))
    _scale_close(dred, dred_r)
    assert 0.1 < acc.float().mean() < 0.6
    # and close to the f32 decision of the same spectra
    acc32, dred32, _, _ = TS.predict_classes(port, xs)
    assert (acc == acc32).float().mean() >= 0.995
    np.testing.assert_allclose(dred.numpy(), dred32.numpy(), rtol=0,
                               atol=3e-2 * dred32.abs().max().item())


def test_int8_gemm_wide_l_and_offset_free(models):
    """One model (no offset) through the same op, and an L past 2^12:
    the product stays exact (|sum| <= 127^2 L < 2^31)."""
    ref, port, xs, _ = models
    prep = TL.quantize_rows_int8(xs - port.mean[1].numpy())
    zero = np.zeros((1, LENGTH), np.float32)
    t2, q, _ = TL.t2_q_scores_multiclass_int8(
        *(torch.from_numpy(a) for a in prep), torch.from_numpy(zero),
        port.components[1:2], port.invcovT[1:2])
    t2_r, q_r, _ = JL.t2_q_scores_multiclass_int8(
        *(jnp.asarray(a) for a in prep), jnp.asarray(zero),
        ref.components[1:2], ref.invcovT[1:2])
    _scale_close(t2, t2_r)
    _scale_close(q, q_r)
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 5000), dtype=np.int8))
    w = torch.full((2, 5000), 127, dtype=torch.int8)
    g = kernels.int8_gemm_s32(a, w)
    want = a.numpy().astype(np.int64) @ w.numpy().astype(np.int64).T
    np.testing.assert_array_equal(g.numpy(), want)
    full = kernels.int8_gemm_s32(w[:1], w)
    assert full.tolist() == [[127 * 127 * 5000] * 2]


def _small_probe():
    n, lp, tiles = probe.SMALL
    xq, wq = probe.make_inputs(n, lp)
    rng = np.random.default_rng(0)                 # the JAX probe's draws
    np.testing.assert_array_equal(
        xq.numpy(), rng.integers(-127, 128, (n, lp), dtype=np.int8))
    np.testing.assert_array_equal(
        wq.numpy(), rng.integers(-127, 128, (lp, 128), dtype=np.int8))
    return xq, wq, tiles[0]


def test_tile_sum_twin_matches_probe_baseline():
    xq, _, tile = _small_probe()
    got = kernels.int8_tile_sum(xq, tile)
    assert got.dtype == torch.int32 and got.shape == (xq.shape[0] // tile,)
    xb = jnp.asarray(xq.numpy())
    assert int(got.to(torch.int64).sum()) == int(jnp.sum(xb.astype(jnp.int32)))
    want = xq.numpy().astype(np.int64).reshape(-1, tile * xq.shape[1]).sum(1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gemm_twin_matches_probe_baseline():
    xq, wq, tile = _small_probe()
    got = kernels.int8_gemm_s32(xq, wq.T.contiguous(), tile)
    assert got.dtype == torch.int32 and got.shape == (xq.shape[0] // tile, 128)
    xb, wb = jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy())
    total = jnp.sum(jax.lax.dot_general(xb, wb, (((1,), (0,)), ((), ())),
                                        preferred_element_type=jnp.int32))
    assert int(got.to(torch.int64).sum()) == int(total)
    prod = xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64)
    np.testing.assert_array_equal(
        got.numpy(), prod.reshape(-1, tile, 128).sum(1))
    store = kernels.int8_gemm_s32(xq, wq.T.contiguous())
    np.testing.assert_array_equal(store.numpy(), prod)


@pytest.mark.parametrize("case", [(1000, 203, 8), (96, 36, 96), (64, 4, 1)],
                         ids=str)
def test_twins_on_ragged_shapes(case):
    n, length, tile = case
    rng = np.random.default_rng(n)
    a = rng.integers(-127, 128, (n, length), dtype=np.int8)
    w = rng.integers(-127, 128, (7, length), dtype=np.int8)
    xq = torch.from_numpy(a)
    np.testing.assert_array_equal(
        kernels.int8_tile_sum(xq, tile).numpy(),
        a.astype(np.int64).reshape(n // tile, -1).sum(1))
    prod = a.astype(np.int64) @ w.astype(np.int64).T
    np.testing.assert_array_equal(
        kernels.int8_gemm_s32(xq, torch.from_numpy(w), tile).numpy(),
        prod.reshape(n // tile, tile, 7).sum(1))


def test_probe_checks_twins_and_needs_a_card():
    xq, wq, tile = _small_probe()
    probe.check(xq, wq.T.contiguous(), (tile,))
    bufs = probe.rotated(xq[:8], 3)
    assert len(bufs) == 3 and not torch.equal(bufs[1], bufs[2])
    assert torch.equal(bufs[0], xq[:8])
    if not torch.cuda.is_available():
        assert probe.main(["--small"]) == 1
        with pytest.raises(RuntimeError, match="CUDA"):
            probe.run(small=True)
