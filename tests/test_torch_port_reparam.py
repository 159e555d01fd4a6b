"""The port's fused reparameterize + KL (kernel K4's wrapper
``reparam_kl`` and its autograd form ``fused_reparam_kl``) against
``ocm_tpu.ops.kernels``, float64 on the CPU.

JAX runs ``reparam_loss_pallas(eps=...)`` and ``fused_reparam_kl`` in
interpret mode; the port runs the plain twin.  Same seeded numpy inputs;
tolerance 1e-12 relative (f64, elementwise plus one row sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.ops import kernels as JK
from ocm_tpu_torch.ops import kernels as TK

RTOL, ATOL = 1e-12, 1e-13
# (N, k): the VAE's latent shape cut in N, ragged rows and a k above 32
SHAPES = [(8, 4), (13, 5), (64, 16), (7, 40)]


def _inputs(n, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, k)), rng.normal(-0.5, 0.8, size=(n, k)),
            rng.normal(size=(n, k)), rng.normal(size=(n, k)),
            rng.normal(size=n))


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reparam_kl_matches_pallas_kernel(shape):
    mu, lv, eps, _, _ = _inputs(*shape)
    z_r, kl_r = JK.reparam_loss_pallas(jnp.asarray(mu), jnp.asarray(lv),
                                       jnp.asarray(eps), interpret=True)
    z, kl = TK.reparam_kl(*(torch.tensor(a) for a in (mu, lv, eps)))
    _close(z, z_r, "z")
    _close(kl, kl_r, "kl")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fused_reparam_kl_gradients_match_jax(shape):
    mu, lv, eps, dz, dkl = _inputs(*shape, seed=1)

    def f(m, v):
        return JK.fused_reparam_kl(m, v, jnp.asarray(eps), True)

    (z_r, kl_r), vjp = jax.vjp(f, jnp.asarray(mu), jnp.asarray(lv))
    dmu_r, dlv_r = vjp((jnp.asarray(dz), jnp.asarray(dkl)))
    mt = torch.tensor(mu, requires_grad=True)
    vt = torch.tensor(lv, requires_grad=True)
    et = torch.tensor(eps, requires_grad=True)
    z, kl = TK.fused_reparam_kl(mt, vt, et)
    torch.autograd.backward((z, kl), (torch.tensor(dz), torch.tensor(dkl)))
    _close(z.detach(), z_r, "z")
    _close(kl.detach(), kl_r, "kl")
    _close(mt.grad, dmu_r, "dmu")
    _close(vt.grad, dlv_r, "dlogvar")
    assert et.grad is None     # eps gets no gradient, as in JAX (zeros)


def test_fused_reparam_kl_gradcheck():
    mu, lv, eps, _, _ = _inputs(5, 3, seed=2)
    mt = torch.tensor(mu, requires_grad=True)
    vt = torch.tensor(lv, requires_grad=True)
    et = torch.tensor(eps)
    assert torch.autograd.gradcheck(
        lambda m, v: TK.fused_reparam_kl(m, v, et), (mt, vt))


def test_kl_equals_the_losses_kl_divergence():
    """The train step's KL term (mean of K4's per-sample KL) is
    ``kl_divergence`` of the reference."""
    from ocm_tpu.models.vae import kl_divergence
    mu, lv, eps, _, _ = _inputs(64, 16, seed=3)
    _, kl = TK.reparam_kl(*(torch.tensor(a) for a in (mu, lv, eps)))
    _close(kl.mean(), kl_divergence(jnp.asarray(mu), jnp.asarray(lv)), "KL")


# --- kernel K5: the noise drawn in the kernel ------------------------------
#
# JAX's eps=None branch cannot be compared: its interpreter fills the
# random bits with a constant (ocm_tpu/ops/kernels.py:117-120).  So the
# port's noise is held to the Random123 Philox known answers and to N(0, 1)
# in distribution, and z/KL to the Pallas kernel handed that same noise.

# (counter, key, output) of Random123's philox4x32_10 known-answer tests
PHILOX_KAT = [((0, 0, 0, 0), (0, 0),
               (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
              ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
               (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD))]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT, ids=["zeros", "ones"])
def test_plain_philox_known_answers(counter, key, want):
    got = TK.philox4x32_plain(torch.tensor([counter], dtype=torch.int64), key)
    assert tuple(got[0].tolist()) == want


def test_sampled_noise_is_deterministic_and_keyed():
    a = TK.philox_normal_plain(50, 7, seed=2 ** 40 + 3, offset=1)
    np.testing.assert_array_equal(
        a, TK.philox_normal_plain(50, 7, seed=2 ** 40 + 3, offset=1))
    others = [TK.philox_normal_plain(50, 7, seed=2 ** 40 + 4, offset=1),
              TK.philox_normal_plain(50, 7, seed=2 ** 40 + 3, offset=2),
              TK.philox_normal_plain(50, 7, seed=3, offset=1)]
    for b in others:
        assert float(torch.corrcoef(torch.stack([a.flatten(),
                                                 b.flatten()]))[0, 1]) < 0.1
        assert not torch.equal(a, b)
    # element (row, col) depends on (seed, offset, row * k + col) only
    tall = TK.philox_normal_plain(100, 7, seed=2 ** 40 + 3, offset=1)
    np.testing.assert_array_equal(tall[:50], a)


def test_sampled_noise_is_standard_normal():
    from scipy import stats

    eps = TK.philox_normal_plain(10_000, 10, seed=17,
                                 dtype=torch.float64).numpy()
    flat = eps.ravel()
    assert abs(flat.mean()) < 0.01 and abs(flat.var() - 1.0) < 0.015
    assert stats.kstest(flat, "norm").statistic < 0.005
    # Box-Muller of 24-bit uniforms, u1 >= 1e-7
    assert np.abs(flat).max() <= np.sqrt(-2.0 * np.log(1e-7)) + 1e-12
    for a, b in ((eps[:, :-1], eps[:, 1:]), (eps[:-1], eps[1:])):
        assert abs(np.corrcoef(a.ravel(), b.ravel())[0, 1]) < 0.01


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_reparam_kl_sample_matches_pallas_kernel_given_its_noise(shape):
    mu, lv, _, _, _ = _inputs(*shape, seed=4)
    z, kl, eps = TK.reparam_kl_sample_plain(torch.tensor(mu), torch.tensor(lv),
                                            seed=99, offset=5)
    z_r, kl_r = JK.reparam_loss_pallas(jnp.asarray(mu), jnp.asarray(lv),
                                       jnp.asarray(eps.numpy()),
                                       interpret=True)
    _close(z, z_r, "z")
    _close(kl, kl_r, "kl")
    z_w, kl_w = TK.reparam_kl_sample(torch.tensor(mu), torch.tensor(lv), 99, 5)
    assert torch.equal(z_w, z) and torch.equal(kl_w, kl)


# --- K6's backward: the VJP as one kernel on the card ----------------------
#
# Its plain twin against JAX's VJP of fused_reparam_kl (interpret mode),
# f64.  Tolerance 1e-10 relative: both evaluate the same elementwise
# formula, with no sum, so only the two libraries' exp and the order of a
# few products differ (a few ulp); dlv's difference of two terms may
# cancel, so the absolute part is 1e-10 of the output's scale.
BWD_SHAPES = [(64, 16), (300, 5), (7, 33), (3, 129)]


@pytest.mark.parametrize("dkl_kind", ["full", "stride0"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=str)
def test_reparam_kl_bwd_plain_matches_jax_vjp(shape, dkl_kind):
    mu, lv, eps, dz, dkl = _inputs(*shape, seed=5)
    if dkl_kind == "stride0":   # kl.mean()'s gradient, an expanded scalar
        dkl_t = torch.tensor(1.0 / shape[0], dtype=torch.float64).expand(
            shape[0])
        assert dkl_t.stride() == (0,)
        dkl = dkl_t.numpy().copy()
    else:
        dkl_t = torch.tensor(dkl)

    def f(m, v):
        return JK.fused_reparam_kl(m, v, jnp.asarray(eps), True)

    _, vjp = jax.vjp(f, jnp.asarray(mu), jnp.asarray(lv))
    dmu_r, dlv_r = vjp((jnp.asarray(dz), jnp.asarray(dkl)))
    dmu, dlv = TK.reparam_kl_bwd(torch.tensor(mu), torch.tensor(lv),
                                 torch.tensor(eps), torch.tensor(dz), dkl_t)
    for what, got, ref in (("dmu", dmu, dmu_r), ("dlogvar", dlv, dlv_r)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max(),
                                   err_msg=what)


def test_fused_reparam_kl_backward_is_the_plain_vjp():
    """The autograd form's gradients are ``reparam_kl_bwd_plain``'s, also
    for a non-contiguous dz and when z goes unused (autograd hands the
    backward a zero dz)."""
    mu, lv, eps, dz, _ = _inputs(6, 8, seed=6)
    mt = torch.tensor(mu, requires_grad=True)
    vt = torch.tensor(lv, requires_grad=True)
    z, kl = TK.fused_reparam_kl(mt, vt, torch.tensor(eps))
    dz_t = torch.tensor(dz.T.copy()).T          # column-major
    assert not dz_t.is_contiguous()
    dmu, dlv = torch.autograd.grad((z, kl.mean()), (mt, vt), (dz_t, None),
                                   retain_graph=True)
    dkl = torch.full((6,), 1.0 / 6, dtype=torch.float64)
    ref = TK.reparam_kl_bwd_plain(*(torch.tensor(a) for a in (mu, lv, eps)),
                                  torch.tensor(dz), dkl)
    _close(dmu, ref[0], "dmu")
    _close(dlv, ref[1], "dlogvar")
    dmu0, dlv0 = torch.autograd.grad(kl.sum(), (mt, vt))
    ref0 = TK.reparam_kl_bwd_plain(*(torch.tensor(a) for a in (mu, lv, eps)),
                                   torch.zeros(6, 8, dtype=torch.float64),
                                   torch.ones(6, dtype=torch.float64))
    _close(dmu0, ref0[0], "dmu, z unused")
    _close(dlv0, ref0[1], "dlogvar, z unused")


# --- reparam_plan: the row groups of K4, K6's backward and K5 ---------------

def _pairs_drawn(row, k, lanes):
    """The element pairs each lane of ``row`` draws, in K5's loop
    (csrc/reparam_sample.cu): p = row k // 2 + lane, + lanes, ... while
    2 p < (row + 1) k."""
    first, end = row * k, (row + 1) * k
    return [list(range((first >> 1) + lane, (end + 1) // 2, lanes))
            for lane in range(lanes)]


@pytest.mark.parametrize("sampled", [False, True], ids=["k4_k6", "k5"])
@pytest.mark.parametrize("n", [1, 7, 64, 512, 65536])
def test_reparam_plan_covers_every_element_once(n, sampled):
    for k in range(1, 131):
        for align in (16, 8, 4):
            plan = TK.reparam_plan(n, k, align, sampled)
            g = plan.lanes
            assert g in (1, 2, 4, 8, 16, 32), (k, plan)
            assert g * plan.rows == TK.REPARAM_THREADS, (k, plan)
            assert plan.blocks * plan.rows >= n > (plan.blocks - 1) * plan.rows
            vf = plan.vec // 4
            assert plan.vec in ((8, 4) if sampled else (16, 8, 4))
            assert plan.vec <= align and k % vf == 0, (k, align, plan)
            for row in {0, 1 % n, n - 1}:
                if not sampled:
                    steps = k // vf
                    assert g == min(32, 1 << (steps - 1).bit_length())
                    owner = np.full(k, -1)
                    for lane in range(g):
                        for u in range(lane, steps, g):
                            assert (owner[u * vf:(u + 1) * vf] == -1).all()
                            owner[u * vf:(u + 1) * vf] = lane
                    assert (owner >= 0).all(), (k, plan)
                    continue
                first, end = row * k, (row + 1) * k
                touched = {e >> 1 for e in range(first, end)}
                assert len(touched) == (k + 1) // 2 and g == min(
                    32, 1 << (len(touched) - 1).bit_length())
                drawn = _pairs_drawn(row, k, g)
                flat = [p for lane in drawn for p in lane]
                assert sorted(flat) == sorted(touched), (k, row)
                written = [e for p in flat for e in (2 * p, 2 * p + 1)
                           if first <= e < end]
                assert sorted(written) == list(range(first, end)), (k, row)
                if plan.vec == 8:   # pairs never straddle rows
                    assert k % 2 == 0 and all(
                        first <= 2 * p and 2 * p + 1 < end for p in flat)


def test_reparam_plan_at_the_path_shapes():
    # the train batch in one block of 256 threads, 4 lanes of float4 a row
    assert TK.reparam_plan(64, 16) == TK.ReparamPlan(4, 64, 1, 16)
    # K5: 8 lanes a row, every lane busy; the screen chunk in 2,048 blocks
    assert TK.reparam_plan(512, 16, sampled=True) == TK.ReparamPlan(
        8, 32, 16, 8)
    assert TK.reparam_plan(65536, 16, sampled=True) == TK.ReparamPlan(
        8, 32, 2048, 8)
    assert TK.reparam_plan(300, 5, sampled=True).lanes == 4
    # unaligned bases fall back to narrower accesses
    assert TK.reparam_plan(64, 16, 8).vec == 8
    assert TK.reparam_plan(64, 16, 4) == TK.ReparamPlan(16, 16, 4, 4)
    with pytest.raises(ValueError, match="empty"):
        TK.reparam_plan(0, 16)
