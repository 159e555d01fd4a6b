"""A pool of gloo ranks for the port's ``parallel`` tests.

``RankPool(world)`` spawns ``world`` processes (the ``spawn`` start method)
once per test module; each joins one gloo process group on the CPU (a
``file://`` store, a group timeout) and runs the jobs it is sent: the
``job_*`` functions of this module, by name, each on a mesh that the rank
builds once per (shape, axis names).  Jobs take and return numpy (and
plain Python) values.  A job that raises in any rank fails the call with
that rank's traceback; a rank that hangs or dies fails it at the timeout.
This module imports torch, numpy and ``ocm_tpu_torch`` only (never JAX), so
the ranks stay light.
"""

import datetime
import os
import queue
import tempfile
import traceback

import numpy as np

RANK_TIMEOUT_S = 120


def _rank_main(rank, world, init_file, jobs, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            name, args = job
            try:
                results.put((rank, "ok", globals()[name](*args)))
            except Exception:
                results.put((rank, "err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks that run ``job_*`` functions on request."""

    def __init__(self, world: int):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self._dir = tempfile.mkdtemp(prefix="ocm_ranks_")
        init_file = os.path.join(self._dir, "store")
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, world, init_file, self._jobs[r],
                                         self._results))
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, job, *args, timeout: float = RANK_TIMEOUT_S) -> list:
        """``job(*args)`` on every rank; its results, in rank order."""
        for q in self._jobs:
            q.put((job.__name__, args))
        out, errors = [None] * self.world, []
        for _ in range(self.world):
            try:
                rank, status, value = self._results.get(timeout=timeout)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                raise RuntimeError(f"{job.__name__}: no answer within "
                                   f"{timeout} s (dead ranks: {dead})")
            if status == "err":
                errors.append(f"rank {rank}:\n{value}")
            out[rank] = value
        if errors:
            raise RuntimeError(f"{job.__name__} failed\n" + "\n".join(errors))
        return out

    def close(self):
        for q in self._jobs:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        for name in os.listdir(self._dir):
            os.remove(os.path.join(self._dir, name))
        os.rmdir(self._dir)


# --- the rank side ----------------------------------------------------------

_MESHES = {}


def _mesh(shape, names):
    from ocm_tpu_torch.parallel.mesh import make_mesh

    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(shape, names, device="cpu")
    return _MESHES[key]


def _np(tree):
    """Tensors of a tree of dicts, tuples and lists as numpy."""
    import torch

    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree) if not hasattr(
            tree, "_fields") else {f: _np(v) for f, v in
                                   zip(tree._fields, tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def job_axis_info(shape, names):
    m = _mesh(shape, names)
    return {a: (m.axis_index(a), m.shape[a]) for a in m.axis_names}


def job_fit(shape, names, x, w, k, kw):
    import torch

    from ocm_tpu_torch.parallel.simca_dist import fit_simca_sharded

    m = _mesh(shape, names)
    if "omega" in kw:
        kw = {**kw, "omega": torch.as_tensor(kw["omega"])}
    sink = []
    with m.recording(sink):
        model = fit_simca_sharded(x, w, k, m, **kw)
    return _np(model), sink


def job_predict(shape, names, model_tree, x, decision_type):
    from ocm_tpu_torch.models.simca import simca_model_from_numpy
    from ocm_tpu_torch.parallel.simca_dist import predict_sharded

    m = _mesh(shape, names)
    model = simca_model_from_numpy(model_tree, device="cpu")
    sink = []
    with m.recording(sink):
        out = predict_sharded(model, x, m, decision_type)
    return _np(out), sink


def job_moments(shape, names, length, batches):
    import torch

    from ocm_tpu_torch.models import streaming
    from ocm_tpu_torch.parallel.simca_dist import moments_update_sharded

    m = _mesh(shape, names)
    mom = streaming.moments_init(length, torch.float64, device="cpu")
    sink = []
    with m.recording(sink):
        for x, w in batches:
            mom = moments_update_sharded(mom, x, m, w)
    return _np(mom), sink


def job_cv(shape, names, fn_name, args, kw):
    import torch

    from ocm_tpu_torch.parallel import simca_dist

    m = _mesh(shape, names)
    if "omega" in kw:
        kw = {**kw, "omega": torch.as_tensor(kw["omega"])}
    sink = []
    out = getattr(simca_dist, fn_name)(*args, mesh=m, hlo_sink=sink, **kw)
    return out, sink


def _dp_model(tree, arch):
    import torch

    from ocm_tpu_torch.models.vae import ConvVAE1D, vae_state_dict_from_numpy

    model = ConvVAE1D(**arch, bn_axis_name="data").double()
    params, stats = tree
    model.load_state_dict(vae_state_dict_from_numpy(params, stats, model))
    return model, torch.optim.Adam


def job_dp_steps(shape, names, tree, arch, cfg_kw, xbs, epss):
    """The data-parallel step over global batches ``xbs`` with noise
    ``epss`` (each rank takes its rows): the losses, the first step's
    gradients (before the update) and the final state."""
    import torch

    from ocm_tpu_torch.models.trainer import TrainConfig
    from ocm_tpu_torch.parallel.train_dist import (make_dp_eval_loss,
                                                   make_dp_train_step)

    m = _mesh(shape, names)
    model, adam = _dp_model(tree, arch)
    cfg = TrainConfig(**cfg_kw)
    opt = adam(model.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay)
    step = make_dp_train_step(model, opt, cfg, m)
    rows = m.rows(xbs.shape[1], "data")
    losses, grads, sink = [], None, []
    for i, (xb, eps) in enumerate(zip(xbs, epss)):
        with m.recording(sink if i == 0 else None):
            losses.append(float(step(torch.as_tensor(xb[rows]),
                                     torch.as_tensor(eps[rows]))))
        if i == 0:
            grads = {k: p.grad.numpy().copy()
                     for k, p in model.named_parameters()}
    ev = make_dp_eval_loss(model, cfg, m)
    val = float(ev(torch.as_tensor(xbs[0][rows]),
                   torch.as_tensor(epss[0][rows])))
    return (losses, grads, _np(model.state_dict()), val, sink)


def job_train_dp(shape, names, arch, cfg_kw, x_cal, x_val, seed):
    from ocm_tpu_torch.models.trainer import TrainConfig
    from ocm_tpu_torch.models.vae import ConvVAE1D
    from ocm_tpu_torch.parallel.train_dist import train_vae_dp

    m = _mesh(shape, names)
    model = ConvVAE1D(**arch, bn_axis_name="data").double()
    bundle, tl, vl, best = train_vae_dp(model, x_cal, x_val,
                                        TrainConfig(**cfg_kw), seed, m)
    return tl, vl, best, _np(bundle.state_dict)


def job_vmapped_sharded(shape, names, arch, x_cal, x_val, lrs, wds, betas,
                        kw):
    from ocm_tpu_torch.models.vae import ConvVAE1D
    from ocm_tpu_torch.parallel.sweep_dist import train_vae_vmapped_sharded

    m = _mesh(shape, names)
    r = train_vae_vmapped_sharded(ConvVAE1D(**arch), x_cal, x_val, lrs, wds,
                                  betas, m, **kw)
    return _np(r._replace(bundle=r.bundle._asdict()))


def job_classes_sharded(shape, names, arch, x_cals, x_vals, cfg_kw, seed):
    from ocm_tpu_torch.models.trainer import TrainConfig
    from ocm_tpu_torch.models.vae import ConvVAE1D
    from ocm_tpu_torch.parallel.sweep_dist import train_vae_classes_sharded

    m = _mesh(shape, names)
    r = train_vae_classes_sharded(ConvVAE1D(**arch), x_cals, x_vals,
                                  TrainConfig(**cfg_kw), m, seed)
    return _np(r._replace(bundle=r.bundle._asdict()))


def job_stacked_slice_steps(shape, names, trees, arch, lrs, wds, betas,
                            loss_type, xs, epss):
    """Each rank's slice of C configs (``sweep_dist``'s split of the model
    axis) as one stacked module, stepped on the given batches and noise:
    (the rank's config indices, its losses (steps, C_rank))."""
    import torch

    from ocm_tpu_torch.models import stacked
    from ocm_tpu_torch.models.trainer import TrainConfig
    from ocm_tpu_torch.models.vae import ConvVAE1D
    from ocm_tpu_torch.parallel.sweep_dist import _my_units

    m = _mesh(shape, names)
    mine = _my_units(len(lrs), m, "model")
    params, stats = trees
    tmodel = ConvVAE1D(**arch)
    take = lambda t: {k: (take(v) if isinstance(v, dict) else v[mine])
                      for k, v in t.items()}
    smodel = stacked.stacked_vae(tmodel, stacked.stacked_state_dict_from_numpy(
        take(params), take(stats), tmodel))
    opt = stacked.StackedAdam(smodel, [lrs[c] for c in mine],
                              [wds[c] for c in mine])
    step = stacked.make_stacked_train_step(
        smodel, opt, TrainConfig(loss_type=loss_type),
        [betas[c] for c in mine])
    losses = [step(torch.tensor(x[mine]), torch.tensor(e[mine])).numpy()
              for x, e in zip(xs, epss)]
    return mine, np.stack(losses)


def job_simca_scorer(shape, names, model_tree, x, kw, store, raw):
    import torch

    from ocm_tpu_torch.models.simca import simca_model_from_numpy
    from ocm_tpu_torch.ops.preprocess import snv_savgol
    from ocm_tpu_torch.serving import SIMCAScorer

    m = _mesh(shape, names)
    model = simca_model_from_numpy(model_tree, device="cpu")
    dtype = {None: None, "bf16": torch.bfloat16, "int8": torch.int8}[store]
    extra = {"preprocess_fn": lambda v: snv_savgol(v, 5, 2, 1)} if raw else {}
    scorer = SIMCAScorer(model, mesh=m, store_dtype=dtype, **kw, **extra)
    return scorer.score(x), scorer.score_prepared(scorer.prepare(x))


def job_vae_scorer(shape, names, arch, bundle_tree, x, variant, kw):
    from ocm_tpu_torch.models import bundle as B
    from ocm_tpu_torch.models.vae import ConvVAE1D
    from ocm_tpu_torch.serving import VAEScorer

    m = _mesh(shape, names)
    model = ConvVAE1D(**arch).double()
    bundle = B.ocm_bundle_from_numpy(bundle_tree, model, device="cpu")
    return VAEScorer(model, bundle, variant=variant, mesh=m, **kw).score(x)


def job_search(shape, names, fn_name, x_cal, x_val, kw):
    from ocm_tpu_torch.utils import sweep, tpe

    m = _mesh(shape, names)
    fn = getattr(sweep, fn_name, None) or getattr(tpe, fn_name)
    out = fn(x_cal, x_val, mesh=m, verbose=False, **kw)
    return {k: _np(v) for k, v in out.items()
            if k not in ("best_bundle",)}, _np(out["best_bundle"]._asdict())


def job_raises(shape, names, what):
    """The message of the error ``what`` raises on this rank's mesh."""
    from ocm_tpu_torch.parallel import sweep_dist, train_dist
    from ocm_tpu_torch.models.trainer import TrainConfig
    from ocm_tpu_torch.models.vae import ConvVAE1D

    m = _mesh(shape, names)
    arch = dict(input_length=40, latent_dim=4, conv_blocks=1, n_filters=4,
                hidden_fc=16)
    x = np.zeros((32, 40), np.float32)
    try:
        if what == "sweep_no_model_axis":
            sweep_dist.train_vae_vmapped_sharded(
                ConvVAE1D(**arch), x, x, [1e-3], [0.0], [1.0], m, epochs=1,
                batch_size=16, loss_type="euclidean")
        elif what == "classes_no_model_axis":
            sweep_dist.train_vae_classes_sharded(
                ConvVAE1D(**arch), [x], [x], TrainConfig(epochs=1), m)
        elif what == "dp_batch":
            train_dist.train_vae_dp(ConvVAE1D(**arch, bn_axis_name="data"),
                                    x, x, TrainConfig(batch_size=31), 0, m)
        elif what == "dp_local_bn":
            train_dist.train_vae_dp(ConvVAE1D(**arch), x, x,
                                    TrainConfig(batch_size=32), 0, m)
        elif what == "lengths":
            sweep_dist.train_vae_vmapped_sharded(
                ConvVAE1D(**arch), x, x, [1e-3, 2e-3], [0.0], [1.0], m,
                epochs=1, batch_size=16, loss_type="euclidean",
                model_axis="data")
    except (ValueError, TypeError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


def job_sweep_records(shape, names, arch, x_cal, x_val, n_cfg):
    """The records of a config-sharded sweep of ``n_cfg`` configs."""
    from ocm_tpu_torch.models.vae import ConvVAE1D
    from ocm_tpu_torch.parallel.sweep_dist import train_vae_vmapped_sharded

    m = _mesh(shape, names)
    sink = []
    with m.recording(sink):
        train_vae_vmapped_sharded(
            ConvVAE1D(**arch), x_cal, x_val, [1e-3] * n_cfg, [0.0] * n_cfg,
            [0.5] * n_cfg, m, epochs=1, batch_size=8, loss_type="euclidean")
    return sink


def job_dp_records(shape, names, arch, xb, eps):
    """The records of one float32 data-parallel step on the global batch
    ``xb`` (each rank its rows) and the model's parameter count."""
    import torch

    from ocm_tpu_torch.models.trainer import TrainConfig
    from ocm_tpu_torch.models.vae import ConvVAE1D
    from ocm_tpu_torch.parallel.train_dist import make_dp_train_step

    m = _mesh(shape, names)
    model = ConvVAE1D(**arch, bn_axis_name="data")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_dp_train_step(model, opt, TrainConfig(loss_type="euclidean"),
                              m)
    rows = m.rows(xb.shape[0], "data")
    sink = []
    with m.recording(sink):
        step(torch.as_tensor(xb[rows]), torch.as_tensor(eps[rows]))
    return sink, sum(p.numel() for p in model.parameters())


def job_polluted_ingest(shape, names, x, extra):
    """A twin of ``moments_update_sharded``'s collectives with one extra
    reduction: ``"dependent"`` re-reduces the reduced scatter,
    ``"independent"`` reduces one more vector; ``"none"`` is clean.
    Returns the records."""
    import torch

    m = _mesh(shape, names)
    x_loc = torch.as_tensor(x[m.rows(x.shape[0], "data")])
    w = torch.ones(x_loc.shape[0], dtype=x_loc.dtype)
    sink = []
    with m.recording(sink):
        nb, s = m.psum([w.sum()[None], (w[:, None] * x_loc).sum(0)], "data",
                       "count+sum")
        xc = x_loc - s / nb
        scatter = m.psum(xc.T @ xc, "data", "scatter")
        if extra == "dependent":
            m.psum(scatter, "data", "scatter again")
        elif extra == "independent":
            m.psum((x_loc ** 2).sum(0), "data", "smuggled")
    return sink
