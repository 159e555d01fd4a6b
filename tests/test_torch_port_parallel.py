"""The port's ``parallel`` package on gloo process groups, held against
``ocm_tpu.parallel`` on the virtual CPU devices, in float64.

The port side runs in a pool of 4 gloo ranks spawned once for the module
(``torch_port_dist_util.RankPool``): a 1-D mesh of 4 ranks, or (2, 2); the
JAX side runs the same entry point on a mesh of as many of
``tests/conftest.py``'s 8 virtual devices, in the same shape, on the same
seeded numpy inputs.  Tolerances are those ``tests/test_parallel.py``
holds each sharded path to against its local twin: the fits mean 1e-12,
|components| 1e-9, limits 1e-9 relative; CV 1e-8 with equal predictions;
moments 1e-12; predictions equal with dred 1e-9.  The data-parallel step
takes batches and noise passed in (JAX's random bits cannot be replayed);
the sharded sweeps are held bit for bit to the port's local stacked runs,
and their stacked steps to a JAX ``shard_map`` of vmapped steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ocm_tpu.models import streaming as JStr
from ocm_tpu.models import vae as JV
from ocm_tpu.models.trainer import TrainConfig as JTrainConfig
from ocm_tpu.models.trainer import torch_adam
from ocm_tpu.parallel import mesh as JM
from ocm_tpu.parallel import simca_dist as JD
from ocm_tpu.utils import sweep as JS
from ocm_tpu_torch.models import bundle as TBd
from ocm_tpu_torch.models import cv as TCV
from ocm_tpu_torch.models import simca as TSim
from ocm_tpu_torch.models import trainer as TT
from ocm_tpu_torch.models import vae as TV
from ocm_tpu_torch.parallel import mesh as TM
from ocm_tpu_torch.parallel import simca_dist as TD
from ocm_tpu_torch.serving import SIMCAScorer, VAEScorer
from ocm_tpu_torch.utils import sweep as TS
from ocm_tpu_torch.utils import tpe as TTPE

import torch_port_dist_util as U
from oracles import make_class_spectra
from torch_port_data import (VAE_SMALL, counts_u16, perturb_bn,
                             simca_classes_pair, simca_numpy_tree,
                             vae_bundle_pair, vae_spectra)

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


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return JM.make_mesh(shape, names, devices=jax.devices()[:n])


def _same(results):
    """Every rank's result equal to rank 0's (replicated outputs)."""
    first = results[0]
    for r in results[1:]:
        jax.tree.map(np.testing.assert_array_equal, r, first)
    return first


def _jax_omega(length, s):
    return np.array(jax.random.normal(jax.random.PRNGKey(7), (length, s),
                                      jnp.float64))


@pytest.fixture(scope="module")
def cls_data():
    return make_class_spectra(np.random.default_rng(21), 120, 40)


@pytest.fixture(scope="module")
def cv_data(cls_data):
    rng = np.random.default_rng(5)
    x_other = make_class_spectra(rng, 40, 40, center_shift=1.5)
    x = np.concatenate([cls_data, x_other])
    return x, np.concatenate([np.zeros(len(cls_data)), np.ones(40)])


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_layout_matches_jax(pool):
    """Rank r sits where JAX puts device r of the same shape, and each axis
    has the JAX mesh's size; a mesh of size 1 needs no process group."""
    infos = pool.run(U.job_axis_info, *MD)
    jm = _jmesh(*MD)
    for r, info in enumerate(infos):
        pos = np.argwhere(np.vectorize(lambda d: d.id)(jm.devices) == r)[0]
        assert info == {"model": (int(pos[0]), 2), "data": (int(pos[1]), 2)}
    one = TM.make_mesh(device="cpu")
    assert one.shape == {"data": 1} and one.size == 1
    with pytest.raises(ValueError, match=r"mesh shape \(2,\) != 1 ranks"):
        TM.make_mesh((2,), device="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        TM.make_mesh((1,), ("model", "data"), device="cpu")


def test_padding_and_shard_helpers(cls_data):
    """``tests/test_parallel.py``'s padding cases: edge padding to a
    multiple, cyclic padding of numpy and tensors, the divisibility error,
    and the missing-axis and wrong-type guards."""
    padded, n_true = TM.pad_to_multiple(cls_data[:10], 8)
    assert padded.shape[0] == 16 and n_true == 10
    np.testing.assert_array_equal(padded[10], padded[9])
    a = np.arange(10).reshape(5, 2)
    b = torch.arange(5.0)
    (pa, pb), pad = TM.cyclic_pad((a, b), 8)
    assert pad == 3 and isinstance(pa, np.ndarray) and pa.shape == (8, 2)
    np.testing.assert_array_equal(pa[5:], a[:3])
    assert isinstance(pb, torch.Tensor)
    np.testing.assert_array_equal(pb[5:].numpy(), b[:3].numpy())
    same, pad0 = TM.cyclic_pad((a,), 5)
    assert pad0 == 0 and same[0] is a
    for ours, ref in ((TM.cyclic_pad_to(a, 7), JM.cyclic_pad_to(a, 7)),
                      (TM.pad_to_multiple(a, 4)[0],
                       JM.pad_to_multiple(a, 4)[0])):
        np.testing.assert_array_equal(ours, ref)
    one = TM.make_mesh(device="cpu")
    local = TM.shard_batch(cls_data[:10], one)
    assert local.shape == (10, 40) and local.dtype == torch.float64
    four = TM.Mesh((4,), ("data",), torch.device("cpu"), 0, {"data": None})
    with pytest.raises(ValueError, match="sample count 10 not divisible by "
                       "mesh axis 'data' of size 4; pad the batch first"):
        TM.shard_batch(cls_data[:10], four)
    with pytest.raises(ValueError, match="no axis 'model'"):
        TM.require_mesh_axis(one, "model")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        TM.require_mesh_axis(_jmesh(*D1), "data")


def test_size_one_mesh_runs_in_process(cls_data, cv_data):
    """A mesh of size 1 with no process group: the sharded fit, scoring and
    sweep are the local ones."""
    one = TM.make_mesh(device="cpu")
    w = np.ones(len(cls_data))
    got = TD.fit_simca_sharded(cls_data, w, 5, one)
    ref = TSim.fit_simca_masked(torch.as_tensor(cls_data),
                                torch.as_tensor(w), 5)
    np.testing.assert_allclose(got.mean.numpy(), ref.mean.numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(float(got.d_limit), float(ref.d_limit),
                               rtol=1e-9)
    acc, dred, *_ = TD.predict_sharded(got, cls_data, one)
    acc_r, dred_r, *_ = TSim.simca_decide(ref, torch.as_tensor(cls_data))
    np.testing.assert_array_equal(acc.numpy(), acc_r.numpy())
    from ocm_tpu_torch.models import streaming as TStr

    mask = np.arange(len(cls_data)) % 3 > 0
    for batch in (cls_data, torch.as_tensor(cls_data)):
        mom = TD.moments_update_sharded(
            TStr.moments_init(40, torch.float64, device="cpu"), batch, one,
            w=mask)
        ref = TStr.moments_update(TStr.moments_init(
            40, torch.float64, device="cpu"), cls_data, w=mask)
        for a, b in zip(mom, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12)
    x, y = cv_data
    model_mesh = TM.make_mesh((1,), ("model",), device="cpu")
    sharded = TD.cv_sweep_sharded(x, y, 0, [2, 4], model_mesh)
    local = TCV.cv_simca_sweep(x, y, 0, [2, 4], device="cpu")
    for key in ("sens", "spec", "eff", "pred"):
        np.testing.assert_array_equal(sharded[key], local[key])


# ---------------------------------------------------------------------------
# sample-sharded SIMCA
# ---------------------------------------------------------------------------

FITS = [("eigh", "alt", "Fdist", "jm"), ("eigh", "dd", "chi2pom", "chi2pom"),
        ("eigh", "ci", "perc", "perc"), ("rsvd", "alt", "Fdist", "jm")]


def _fit_inputs(cls_data):
    x, n_true = JM.pad_to_multiple(cls_data, 8)
    return x, (np.arange(x.shape[0]) < n_true).astype(np.float64)


@pytest.mark.parametrize("case", FITS, ids=["-".join(c) for c in FITS])
def test_sharded_fit_matches_jax(pool, cls_data, case):
    solver, dt, t2m, qm = case
    x, w = _fit_inputs(cls_data)
    kw = dict(decision_type=dt, t2_method=t2m, q_method=qm, solver=solver)
    ref = JD.fit_simca_sharded(x, w, 5, _jmesh(*D1), **kw)
    if solver == "rsvd":
        kw["omega"] = _jax_omega(40, 15)
    got = _same([m for m, _ in pool.run(U.job_fit, *D1, x, w, 5, kw)])
    np.testing.assert_allclose(got["mean"], np.asarray(ref.mean), atol=1e-12)
    np.testing.assert_allclose(np.abs(got["components"]),
                               np.abs(np.asarray(ref.components)), atol=1e-9)
    for key, r in (("t2_res", ref.t2_res), ("q_res", ref.q_res)):
        np.testing.assert_allclose(got[key]["limit"], float(r.limit),
                                   rtol=1e-9)
    np.testing.assert_allclose(got["d_limit"], float(ref.d_limit), rtol=1e-9)
    np.testing.assert_allclose(got["t2_train"], np.asarray(ref.t2_train),
                               rtol=1e-9, atol=1e-12)
    assert int(got["n_samples"]) == int(ref.n_samples) == len(cls_data)


def test_predict_sharded_matches_jax(pool, cls_data):
    """Each rank returns its own rows (the sample-sharded outputs);
    concatenated they equal JAX's decisions on the same model."""
    x, w = _fit_inputs(cls_data)
    model = JD.fit_simca_sharded(x, w, 5, _jmesh(*D1))
    x_new, _ = JM.pad_to_multiple(make_class_spectra(
        np.random.default_rng(3), 60, 40, center_shift=0.5), 8)
    ref = JD.predict_sharded(model, x_new, _jmesh(*D1))
    outs = pool.run(U.job_predict, *D1, simca_numpy_tree(model), x_new, "alt")
    acc, dred = (np.concatenate([o[i] for o, _ in outs]) for i in (0, 1))
    assert all(o[0].shape == (16,) for o, _ in outs)
    np.testing.assert_array_equal(acc, np.asarray(ref[0]))
    np.testing.assert_allclose(dred, np.asarray(ref[1]), rtol=1e-9)


def test_moments_sharded_matches_jax(pool, cls_data):
    """Batches of 37 (padded to the axis size) and 40 with a row mask."""
    rng = np.random.default_rng(4)
    batches = [(cls_data[:37], None),
               (cls_data[37:77], (rng.random(40) > 0.3).astype(np.float64))]
    ref = JStr.moments_init(40, dtype=jnp.float64)
    for x, w in batches:
        ref = JD.moments_update_sharded(ref, x, _jmesh(*D1), w)
    got = _same([m for m, _ in pool.run(U.job_moments, *D1, 40, batches)])
    for key in ("n", "mean", "scatter"):
        np.testing.assert_allclose(got[key], np.asarray(getattr(ref, key)),
                                   rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the sharded CV sweeps
# ---------------------------------------------------------------------------

def _cv_close(got, want, pred=True):
    for key in ("sens", "spec", "eff"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=1e-8)
    if pred:
        np.testing.assert_array_equal(got["pred"], np.asarray(want["pred"]))


@pytest.mark.parametrize("solver", ["eigh", "rsvd"])
def test_cv_sweep_sharded_matches_jax(pool, cv_data, solver):
    """5 folds on a 4-rank model axis (cyclic fold padding), against JAX's
    sharded sweep and the port's local sweep."""
    x, y = cv_data
    lvs = [2, 4, 6]
    want = JD.cv_sweep_sharded(x, y, 0, lvs, _jmesh(*M1), n_splits=5,
                               solver=solver)
    kw = dict(n_splits=5, solver=solver)
    if solver == "rsvd":
        kw["omega"] = _jax_omega(40, 16)
    got = _same([o for o, _ in pool.run(U.job_cv, *M1, "cv_sweep_sharded",
                                        (x, y, 0, lvs), kw)])
    _cv_close(got, want)
    _cv_close(got, TCV.cv_simca_sweep(x, y, 0, lvs, device="cpu", **{
        k: (torch.as_tensor(v) if k == "omega" else v)
        for k, v in kw.items()}))


@pytest.mark.parametrize("solver", ["eigh", "rsvd"])
def test_cv_sweep_sharded_multiclass_matches_jax(pool, cls_data, solver):
    """3 classes x 5 folds = 15 units on a 4-rank model axis."""
    rng = np.random.default_rng(23)
    x_b = make_class_spectra(rng, 50, 40, center_shift=1.2)
    x_c = make_class_spectra(rng, 42, 40, center_shift=2.4)
    x = np.concatenate([cls_data, x_b, x_c])
    y = np.repeat([0, 1, 2], [len(cls_data), 50, 42])
    want = JD.cv_sweep_sharded_multiclass(x, y, [0, 1, 2], [2, 4],
                                          _jmesh(*M1), solver=solver)
    kw = {"solver": solver}
    if solver == "rsvd":
        kw["omega"] = _jax_omega(40, 14)
    got = _same([o for o, _ in pool.run(
        U.job_cv, *M1, "cv_sweep_sharded_multiclass", (x, y, [0, 1, 2],
                                                       [2, 4]), kw)])
    _cv_close(got, want)


CASES_2D = [("eigh", "Fdist", "jm", 160), ("rsvd", "Fdist", "jm", 160),
            ("eigh", "perc", "perc", 159)]


@pytest.mark.parametrize("case", CASES_2D,
                         ids=["-".join(map(str, c)) for c in CASES_2D])
def test_cv_sweep_2d_matches_jax(pool, cv_data, case):
    """Folds over the model axis and samples over the data axis of a
    (2, 2) mesh: 5 folds pad to 6; 159 rows pad to 160 outside every
    mask; order-statistic limits read the gathered train statistics."""
    solver, t2m, qm, n = case
    x, y = cv_data[0][:n], cv_data[1][:n]
    kw = dict(n_splits=5, solver=solver, t2_method=t2m, q_method=qm)
    want = JD.cv_sweep_sharded_2d(x, y, 0, [2, 4, 6], _jmesh(*MD), **kw)
    if solver == "rsvd":
        kw["omega"] = _jax_omega(40, 16)
    got = _same([o for o, _ in pool.run(U.job_cv, *MD, "cv_sweep_sharded_2d",
                                        (x, y, 0, [2, 4, 6]), kw)])
    _cv_close(got, want)


# ---------------------------------------------------------------------------
# data-parallel training
# ---------------------------------------------------------------------------

# conv biases ahead of a BatchNorm: their exact gradient is 0, so both
# packages hold rounding there, which Adam turns into lr-sized steps that
# reach nothing but the running mean of the BatchNorm after them
# (tests/test_torch_port_sweep.py)
NOISE = {"encoder_conv.0.bias", "encoder_conv.3.bias", "decoder_conv.0.bias",
         "decoder_conv.3.bias", "encoder_conv.1.running_mean",
         "encoder_conv.4.running_mean", "decoder_conv.1.running_mean",
         "decoder_conv.4.running_mean"}
DP_CFG = dict(lr=2e-3, weight_decay=1e-3, beta=0.5, loss_type="bce")
STEPS, B = 3, 16


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / (np.abs(ref).max() or 1.0)


def _jax_fwd(mod, x, eps):
    mu, lv = mod.encode(x, train=True)
    return mod.decode(mu + eps * jnp.exp(0.5 * lv), train=True), mu, lv


@pytest.fixture(scope="module")
def dp_case():
    """A JAX ``shard_map`` data-parallel step built as
    ``ocm_tpu.parallel.train_dist.make_dp_train_step`` builds it (cross-
    replica BatchNorm through ``bn_axis_name``, gradients and loss psum'd
    with weight n_local / n_global, ``torch_adam``), with the batch and the
    noise passed in: 3 steps from a perturbed initial tree."""
    jmodel = JV.ConvVAE1D(**VAE_SMALL, dtype=jnp.float64, bn_axis_name="data")
    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    params, stats = perturb_bn(*(f64(t) for t in JV.init_vae(
        jmodel, jax.random.key(3))), seed=9)
    x = vae_spectra(STEPS * B, VAE_SMALL["input_length"], seed=8)
    xbs = ((x - x.mean(0)) / x.std(0)).reshape(STEPS, B, -1)
    epss = np.random.default_rng(10).normal(
        size=(STEPS, B, VAE_SMALL["latent_dim"]))
    cfg = JTrainConfig(**DP_CFG)
    tx = torch_adam(cfg.lr, cfg.weight_decay)

    def local(p, s, o, xb, eps):
        n_local = xb.shape[0]
        n_global = jax.lax.psum(n_local, "data")

        def loss_fn(q):
            (x_rec, mu, lv), mut = jmodel.apply(
                {"params": q, "batch_stats": s}, xb, eps, method=_jax_fwd,
                mutable=["batch_stats"])
            total, _, _ = JV.beta_vae_loss(xb, x_rec, mu, lv, beta=cfg.beta,
                                           loss_type=cfg.loss_type)
            return total, mut["batch_stats"]

        (loss, s), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        scale = n_local / n_global
        g = jax.tree.map(lambda a: jax.lax.psum(a * scale, "data"), g)
        loss = jax.lax.psum(loss * scale, "data")
        updates, o = tx.update(g, o, p)
        return optax.apply_updates(p, updates), s, o, loss, g

    step = jax.jit(shard_map(local, mesh=_jmesh(*D1),
                             in_specs=(P(), P(), P(), P("data"), P("data")),
                             out_specs=(P(),) * 5, check_vma=False))
    p, s, o = params, stats, tx.init(params)
    losses, grads = [], None
    for i in range(STEPS):
        p, s, o, loss, g = step(p, s, o, jnp.asarray(xbs[i]),
                                jnp.asarray(epss[i]))
        losses.append(float(loss))
        grads = f64(g) if grads is None else grads
    return (params, stats), xbs, epss, np.asarray(losses), grads, (f64(p),
                                                                  f64(s))


def _single_process(tree, xbs, epss):
    """The port's single-process steps on the same global batches."""
    model = TV.ConvVAE1D(**VAE_SMALL).double()
    model.load_state_dict(TV.vae_state_dict_from_numpy(*tree, model))
    cfg = TT.TrainConfig(**DP_CFG)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                           weight_decay=cfg.weight_decay)
    step = TT.make_train_step(model, opt, cfg)
    losses, grads = [], None
    for i, (xb, eps) in enumerate(zip(xbs, epss)):
        losses.append(float(step(torch.tensor(xb), torch.tensor(eps))))
        if i == 0:
            grads = {k: p.grad.numpy().copy()
                     for k, p in model.named_parameters()}
    return np.asarray(losses), grads, {k: v.numpy() for k, v in
                                       model.state_dict().items()}


def test_dp_step_matches_jax_and_single_process(pool, dp_case):
    """One step's gradients and loss, then a 3-step Adam trajectory, within
    1e-10 of scale of JAX's shard_map step, and within 1e-12 of the port's
    single-process step on the global batch (the reference's claim of
    exact large-batch equivalence).  Every rank ends with the same state."""
    tree, xbs, epss, losses_j, grads_j, final_j = dp_case
    outs = pool.run(U.job_dp_steps, *D1, tree, VAE_SMALL, DP_CFG, xbs, epss)
    losses, grads, state, _, _ = outs[0]
    for o in outs[1:]:
        jax.tree.map(np.testing.assert_array_equal, o[2], state)
    assert _rel(losses, losses_j) <= 1e-10
    tmodel = TV.ConvVAE1D(**VAE_SMALL)
    ref_grads = TV.vae_state_dict_from_numpy(grads_j, tree[1], tmodel)
    for name, g in grads.items():
        assert _rel(g, ref_grads[name].numpy()) <= 1e-10 or (
            name in NOISE and np.abs(g).max() <= 1e-12), name
    ref_state = TV.vae_state_dict_from_numpy(*final_j, tmodel)
    for name, v in state.items():
        if name not in NOISE and "num_batches" not in name:
            assert _rel(v, ref_state[name].numpy()) <= 1e-10, name

    losses_s, grads_s, state_s = _single_process(tree, xbs, epss)
    assert _rel(losses, losses_s) <= 1e-12
    norm = max(np.abs(g).max() for g in grads_s.values())
    for name, g in grads.items():
        assert np.abs(g - grads_s[name]).max() <= 1e-12 * norm, name
    for name, v in state.items():
        if name not in NOISE:
            assert _rel(v, state_s[name]) <= 1e-12, name


def test_dp_eval_loss_matches_single_process(pool, dp_case):
    """The sharded validation loss (eval-mode BatchNorm, noise passed in)
    equals the single-process eval loss of the same state and batch."""
    tree, xbs, epss, *_ = dp_case
    outs = pool.run(U.job_dp_steps, *D1, tree, VAE_SMALL, DP_CFG, xbs, epss)
    val = _same([o[3] for o in outs])
    model = TV.ConvVAE1D(**VAE_SMALL).double()
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in outs[0][2].items()})
    ref = TT.make_eval_loss(model, TT.TrainConfig(**DP_CFG))(
        torch.tensor(xbs[0]), torch.tensor(epss[0]))
    assert abs(val - float(ref)) <= 1e-12 * abs(float(ref))


def test_train_vae_dp_runs_and_learns(pool):
    """``tests/test_parallel.py``'s run: finite, falling losses, the same
    bundle on every rank; the bundle screens in the port as a user would."""
    x = vae_spectra(96, VAE_SMALL["input_length"], seed=9)
    cfg = dict(epochs=4, batch_size=32, lr=2e-3, loss_type="euclidean")
    outs = pool.run(U.job_train_dp, *D1, VAE_SMALL, cfg, x[:64], x[64:], 0)
    tl, vl, best, state = _same(outs)
    assert np.all(np.isfinite(tl)) and np.all(np.isfinite(vl))
    assert tl[-1] < tl[0] and 0 <= best < 4


def test_dp_training_leaves_model_unbound():
    """BatchNorm averages over the ranks only inside a data-parallel step:
    after ``train_vae_dp`` (a mesh of size 1, in process) the model holds
    no reference to the mesh, pickles, and a training pass outside a step
    raises as an unbound cross-replica layer does."""
    import pickle

    from ocm_tpu_torch.parallel.train_dist import train_vae_dp

    one = TM.make_mesh(device="cpu")
    x = vae_spectra(48, VAE_SMALL["input_length"], seed=9)
    model = TV.ConvVAE1D(**VAE_SMALL, bn_axis_name="data").double()
    _, tl, _, _ = train_vae_dp(model, x[:32], x[32:], TT.TrainConfig(
        epochs=2, batch_size=16, loss_type="euclidean"), 0, one)
    assert np.all(np.isfinite(tl))
    layers = [m for m in model.modules() if isinstance(m, TV.BatchNormAct)]
    assert layers and all(m.pmean is None for m in layers)
    pickle.loads(pickle.dumps(model))
    model.train()
    with pytest.raises(RuntimeError, match="trains only in a data-parallel"):
        model.encode(torch.as_tensor(x[:8]))


def test_jax_dp_bundle_screens_equally_in_both_packages():
    """A bundle trained by ``ocm_tpu``'s ``train_vae_dp`` on 4 virtual
    devices loads through the port's bundle loader and screens as in JAX:
    D^2 and Q within f32 rounding (the JAX module computes in float32),
    accepts equal away from the thresholds."""
    from ocm_tpu.models import vae_decision as JVD
    from ocm_tpu.parallel.train_dist import train_vae_dp
    from ocm_tpu_torch.models import vae_decision as TVD
    from torch_port_data import bundle_as_numpy

    x = vae_spectra(96, VAE_SMALL["input_length"], seed=11)
    cfg = JTrainConfig(epochs=2, batch_size=32, lr=2e-3,
                       loss_type="euclidean")
    jb, *_ = train_vae_dp(JV.ConvVAE1D(**VAE_SMALL, bn_axis_name="data"),
                          x[:64], x[64:], cfg, jax.random.key(0),
                          _jmesh(*D1))
    jmodel = JV.ConvVAE1D(**VAE_SMALL)
    jb = JVD.fit_thresholds(jmodel, jb, x[:64], loss_type="euclidean")
    tmodel = TV.ConvVAE1D(**VAE_SMALL)
    tb = TBd.ocm_bundle_from_numpy(bundle_as_numpy(jb), tmodel, device="cpu")
    x_test = np.concatenate([vae_spectra(40, VAE_SMALL["input_length"],
                                         seed=12),
                             vae_spectra(20, VAE_SMALL["input_length"],
                                         seed=13) * 1.3])
    ref = JVD.decide_d2_q(jmodel, jb, x_test, "euclidean")
    got = TVD.decide_d2_q(tmodel, tb, x_test, "euclidean")
    for a, b in ((got.d2, ref.d2), (got.q, ref.q)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    far = ((np.abs(np.asarray(ref.d2) / float(jb.threshold) - 1) > 1e-3)
           & (np.abs(np.asarray(ref.q) / float(jb.threshold_q) - 1) > 1e-3))
    assert far.sum() >= 50
    np.testing.assert_array_equal(got.accept.numpy()[far],
                                  np.asarray(ref.accept)[far])


def test_dp_and_sweep_argument_errors(pool):
    """The reference's guards, on a 4-rank data mesh: a batch not divisible
    by the axis, a model whose BatchNorm is not cross-replica, a sweep on a
    mesh with no model axis."""
    for what, kind, match in [
            ("dp_batch", "ValueError", "not divisible by mesh axis size 4"),
            ("dp_local_bn", "ValueError", "bn_axis_name='data'"),
            ("sweep_no_model_axis", "ValueError", "no axis 'model'"),
            ("classes_no_model_axis", "ValueError", "no axis 'model'"),
            ("lengths", "ValueError", "share their length")]:
        errs = pool.run(U.job_raises, *D1, what)
        for err in errs:
            assert err is not None and err[0] == kind and match in err[1], (
                what, err)


# ---------------------------------------------------------------------------
# config- and class-sharded sweeps
# ---------------------------------------------------------------------------

SWEEP_ARCH = dict(input_length=40, latent_dim=4, conv_blocks=2, n_filters=8,
                  hidden_fc=32)


def _sweep_data():
    rng = np.random.default_rng(31)
    t = np.linspace(0, 1, 40)
    mk = lambda n: (rng.normal(1, 0.06, (n, 1)) * np.sin(2 * np.pi * 3 * t)
                    + rng.normal(0, 0.02, (n, 40)))
    return mk(64), mk(24)


def _assert_results_equal(got, want):
    """A gathered ``TrainResult`` (numpy tree) equal to a local one."""
    np.testing.assert_array_equal(got["train_losses"], want.train_losses)
    np.testing.assert_array_equal(got["val_losses"], want.val_losses)
    np.testing.assert_array_equal(got["best_epoch"], want.best_epoch)
    for k, v in want.final_state.items():
        np.testing.assert_array_equal(got["final_state"][k], v.numpy())
    for k, v in want.bundle.state_dict.items():
        np.testing.assert_array_equal(got["bundle"]["state_dict"][k],
                                      v.numpy())
    np.testing.assert_array_equal(got["bundle"]["spec_mean"],
                                  want.bundle.spec_mean.numpy())
    for key in ("exp_avg", "exp_avg_sq"):
        for k, v in want.final_opt_state[key].items():
            np.testing.assert_array_equal(got["final_opt_state"][key][k],
                                          v.numpy())


def test_vmapped_sharded_equals_local_stacked(pool):
    """5 configs padded to 8 on the 4-rank model axis: every config's run
    equals the local stacked run bit for bit on the CPU (each config's
    layers are its own), losses, best epochs, weights and Adam state."""
    x_cal, x_val = _sweep_data()
    lrs = [3e-4, 1e-3, 2e-3, 5e-3, 1e-2]
    wds, betas = [0.0] * 5, [0.5] * 5
    kw = dict(epochs=3, batch_size=32, loss_type="euclidean", seed=7)
    got = _same(pool.run(U.job_vmapped_sharded, *M1, SWEEP_ARCH, x_cal,
                         x_val, lrs, wds, betas, kw))
    want = TS.train_vae_vmapped(TV.ConvVAE1D(**SWEEP_ARCH), x_cal, x_val,
                                lrs, wds, betas, device="cpu", **kw)
    assert got["val_losses"].shape == (5, 3)
    _assert_results_equal(got, want)


def test_classes_sharded_equals_local(pool):
    """3 classes of unequal sizes (cyclic padding to the largest) on the
    4-rank model axis equal the local class trainer bit for bit."""
    rng = np.random.default_rng(37)
    t = np.linspace(0, 1, 40)
    mk = lambda n, c: (rng.normal(1, .06, (n, 1))
                       * np.sin(2 * np.pi * (3 + c) * t)
                       + rng.normal(0, .02, (n, 40)))
    x_cals = [mk(64, 0), mk(48, 1), mk(56, 2)]
    x_vals = [mk(16, 0), mk(16, 1), mk(16, 2)]
    cfg = dict(epochs=3, batch_size=32, loss_type="euclidean")
    got = _same(pool.run(U.job_classes_sharded, *M1, SWEEP_ARCH, x_cals,
                         x_vals, cfg, 5))
    want = TS.train_vae_classes(TV.ConvVAE1D(**SWEEP_ARCH), x_cals, x_vals,
                                TT.TrainConfig(**cfg), 5, device="cpu")
    assert got["bundle"]["spec_mean"].shape == (3, 40)
    _assert_results_equal(got, want)


def test_sharded_stacked_steps_match_jax_shard_map(pool):
    """5 configs on the 4-rank model axis (padded to 8): each rank's
    stacked step of its configs against a JAX ``shard_map`` over the model
    axis of the vmapped step (BatchNorm through the Pallas kernels in
    interpret mode, ``traced_adam``), batches and noise passed in: losses
    within 1e-10 of scale (``tests/test_torch_port_sweep.py``'s
    stacked-vs-JAX tolerance)."""
    n_cfg, steps, b = 5, 2, 8
    lrs = [1e-3, 3e-3, 5e-4, 2e-3, 1e-2]
    wds = [0.0, 1e-2, 1e-3, 0.0, 0.0]
    betas = [1.0, 0.3, 2.0, 1.0, 0.5]
    jmodel = JV.ConvVAE1D(**VAE_SMALL, dtype=jnp.float64, bn_impl="fused")
    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    inits = [perturb_bn(*(f64(t) for t in JV.init_vae(
        jmodel, jax.random.key(c))), seed=5 + c) for c in range(n_cfg)]
    stack = lambda ts: jax.tree.map(lambda *a: np.stack(a), *ts)
    params, stats = stack([p for p, _ in inits]), stack([s for _, s in inits])
    x = vae_spectra(steps * n_cfg * b, VAE_SMALL["input_length"], seed=6)
    xs = ((x - x.mean(0)) / x.std(0)).reshape(steps, n_cfg, b, -1)
    epss = np.random.default_rng(7).normal(
        size=(steps, n_cfg, b, VAE_SMALL["latent_dim"]))

    def loss_fn(p, s, xb, e, beta):
        (x_rec, mu, lv), mut = jmodel.apply(
            {"params": p, "batch_stats": s}, xb, e, method=_jax_fwd,
            mutable=["batch_stats"])
        total, _, _ = JV.beta_vae_loss(xb, x_rec, mu, lv, beta=beta,
                                       loss_type="bce")
        return total, mut["batch_stats"]

    def one(p, s, o, xb, e, beta, lr, wd):
        (loss, s), g = jax.value_and_grad(loss_fn, has_aux=True)(
            p, s, xb, e, beta)
        updates, o = JS.traced_adam(lr, wd).update(g, o, p)
        return optax.apply_updates(p, updates), s, o, loss

    idx = np.arange(8) % n_cfg
    take = lambda t: jax.tree.map(lambda a: a[idx], t)
    lr_p, wd_p, beta_p = (np.asarray(v)[idx] for v in (lrs, wds, betas))
    opt = jax.vmap(lambda p, lr, wd: JS.traced_adam(lr, wd).init(p))(
        take(params), lr_p, wd_p)
    step = jax.jit(shard_map(jax.vmap(one), mesh=_jmesh(*M1),
                             in_specs=(P("model"),) * 8,
                             out_specs=(P("model"),) * 4, check_vma=False))
    p, s, o, ref = take(params), take(stats), opt, []
    for i in range(steps):
        p, s, o, loss = step(p, s, o, jnp.asarray(xs[i][idx]),
                             jnp.asarray(epss[i][idx]), beta_p, lr_p, wd_p)
        ref.append(np.asarray(loss))
    ref = np.stack(ref)                                   # (steps, 8)
    outs = pool.run(U.job_stacked_slice_steps, *M1, (params, stats),
                    VAE_SMALL, lrs, wds, betas, "bce", xs, epss)
    for rank, (mine, losses) in enumerate(outs):
        sl = slice(2 * rank, 2 * rank + 2)
        np.testing.assert_array_equal(mine, idx[sl])
        assert _rel(losses, ref[:, sl]) <= 1e-10, rank


# ---------------------------------------------------------------------------
# mesh= on the scorers and the searches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def simca_pair():
    from torch_port_data import make_data

    cals, x = make_data(seed=0)
    cals = cals.reshape(-1, cals.shape[-1])
    return simca_classes_pair(cals), x, cals


@pytest.mark.parametrize("store", [None, "bf16", "int8", "raw"])
def test_simca_scorer_mesh_equals_unsharded(pool, simca_pair, store):
    """Each rank decides its rows of every chunk (chunk 64 over the data
    axis of a (2, 2) mesh; 500 spectra, a ragged last chunk) at every
    storage width, and ``score``/``score_prepared`` return the whole dict
    on every rank, equal to the unsharded scorer's."""
    from ocm_tpu_torch.ops.preprocess import snv_savgol

    (_, port), x, cals = simca_pair
    raw = store == "raw"
    tree = TSim.simca_model_to_numpy(port)
    if raw:
        x = counts_u16(x)
        prepped = snv_savgol(torch.as_tensor(counts_u16(cals),
                                             dtype=torch.float64), 5, 2, 1)
        tree = TSim.simca_model_to_numpy(TSim.fit_classes(
            prepped, np.repeat([0, 1, 2], len(cals) // 3), [0, 1, 2], 4,
            device="cpu", solver="rsvd"))
    kw = {"chunk_size": 64}
    outs = pool.run(U.job_simca_scorer, *MD, tree, x, kw,
                    None if raw else store, raw)
    dtype = {None: None, "bf16": torch.bfloat16, "int8": torch.int8,
             "raw": None}[store]
    extra = {"preprocess_fn": lambda v: snv_savgol(v, 5, 2, 1)} if raw else {}
    ref = SIMCAScorer(TSim.simca_model_from_numpy(tree, device="cpu"),
                      store_dtype=dtype, **kw, **extra).score(x)
    for scored, prepared in outs:
        for got in (scored, prepared):
            assert got.keys() == ref.keys()
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("variant,pin", [("d2", False), ("d2_q", False),
                                         ("f", False), ("f", True),
                                         ("full", False)])
def test_vae_scorer_mesh_equals_unsharded(pool, variant, pin):
    """The VAE scorer over a (2, 2) mesh's data axis: row-wise variants
    decide each rank's rows; 'f' and 'full' (batch-wide statistics, quirks
    Q3/Q4) gather the network's per-row outputs and compute the statistics
    over the whole chunk; equal to the unsharded screen (f64, CPU)."""
    x_cal = vae_spectra(60, VAE_SMALL["input_length"], seed=3)
    _, _, tmodel, tb = vae_bundle_pair(x_cal)
    from ocm_tpu_torch.models.vae_decision import fit_thresholds

    tb = fit_thresholds(tmodel, tb, x_cal, loss_type="euclidean")
    x = vae_spectra(100, VAE_SMALL["input_length"], seed=4)
    kw = {"chunk_size": 32, "loss_type": "euclidean", "pin_f_stats": pin}
    outs = pool.run(U.job_vae_scorer, *MD, VAE_SMALL,
                    TBd._numpy_tree(tb, tmodel), x, variant, kw)
    ref = VAEScorer(tmodel, tb, variant=variant, **kw).score(x)
    for got in outs:
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-12,
                                       atol=1e-12, err_msg=k)


SEARCH_SPACE = {"lr": ("loguniform", 1e-4, 1e-2)}
SEARCH_BASE = {"latent_dim": 4, "conv_blocks": 1, "n_filters": 4,
               "kernel_size": 5, "hidden_fc": 16, "batch_size": 32,
               "loss_type": "euclidean"}


@pytest.mark.parametrize("fn", ["asha_vae_search", "bohb_vae_search"])
def test_searches_with_mesh_equal_local(pool, fn):
    """``asha_vae_search(mesh=)`` (fresh rungs config-sharded over a
    (2, 2) mesh's model axis, later rungs resumed locally) and
    ``bohb_vae_search(mesh=)`` return what the unsharded searches return:
    the same schedule, values and best bundle."""
    x_cal, x_val = _sweep_data()
    kw = dict(space=SEARCH_SPACE, max_epochs=4, reduction=2, seed=5,
              base_config=SEARCH_BASE)
    kw.update({"n_trials": 4} if fn == "asha_vae_search"
              else {"n_brackets": 2, "trials_per_bracket": 3})
    outs = pool.run(U.job_search, *MD, fn, x_cal, x_val, kw)
    local_fn = getattr(TS, fn, None) or getattr(TTPE, fn)
    want = local_fn(x_cal, x_val, verbose=False, device="cpu", **kw)
    for got, bundle in outs:
        assert got["best_value"] == want["best_value"]
        assert got["total_epochs"] == want["total_epochs"]
        assert got["best_config"] == want["best_config"]
        assert len(got["history"]) == len(want["history"])
        for k, v in want["best_bundle"].state_dict.items():
            np.testing.assert_array_equal(bundle["state_dict"][k], v.numpy())
