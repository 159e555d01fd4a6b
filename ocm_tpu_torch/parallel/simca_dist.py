"""Distributed SIMCA: sample-sharded fit, scoring and streaming ingest, and
the fold-, unit- and 2-D-sharded CV sweeps (port of
``ocm_tpu/parallel/simca_dist.py``).

Spectra shard over the mesh's ``'data'`` axis; the class statistics
accumulate with all-reduces (count and weighted sum in one round, the
(L, L) scatter in a second: O(L^2) bytes, independent of the sample
count); the decomposition and the limit engines run replicated on every
rank; scoring stays sharded with no collective.  The CV sweeps place
folds (or class x fold units) on the ``'model'`` axis: each rank runs
``models.cv.fold_lv_sweep``, the local sweep's own code, over its
cyclic-padded slice, the outputs are gathered and ``pooled_aggregate``
runs on every rank.  The 2-D sweep also shards samples over the data axis.

The math is the local ``fit_simca_masked`` / ``cv_simca_sweep``'s in a
different summation order.  Covariance-scale products run in full f32
(TF32 off).  The randomized solver takes the local paths' ``omega``.
``hlo_sink`` (a list) receives the mesh's records of the call
(``parallel.mesh``): one line per collective and per sharded input.
"""

from __future__ import annotations

import numpy as np
import torch

from ocm_tpu_torch._device import as_tensor, require_f32
from ocm_tpu_torch.models import cv as cv_mod
from ocm_tpu_torch.models.simca import (K1, SIMCAModel, masked_q_limit,
                                        masked_t2_limit, simca_decide)
from ocm_tpu_torch.models.streaming import (SpectraMoments, moments_merge)
from ocm_tpu_torch.ops.linalg import (ThetaTables, deflated_theta_tables,
                                      deflated_thetas, eigh_desc_signed,
                                      full_f32_matmul, pca_topk_cov,
                                      pinv_psd, thetas_from_tables)
from ocm_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                         cyclic_pad, pad_to_multiple,
                                         require_mesh_axis, shard_batch)
from ocm_tpu_torch.stats import limits as L


def _check_solver(solver: str):
    if solver not in ("eigh", "rsvd"):
        raise ValueError(f"unknown solver {solver!r}; expected 'eigh' or"
                         " 'rsvd'")


def _moved(tree, device):
    """A SIMCAModel (or any NamedTuple of tensors) on ``device``."""
    return type(tree)(*(_moved(v, device) if isinstance(v, tuple)
                        else v.to(device) for v in tree))


def fit_simca_sharded(x, w, n_components: int, mesh: Mesh,
                      decision_type: str = "alt", t2_method: str = "Fdist",
                      q_method: str = "jm", t2_cl: float = 0.95,
                      q_cl: float = 0.95, d_cl: float = 0.95,
                      axis: str = DATA_AXIS, solver: str = "eigh",
                      oversample: int = 10, subspace_iters: int = 4,
                      omega=None) -> SIMCAModel:
    """Masked SIMCA fit with the sample axis sharded over ``mesh[axis]``.

    ``x``: (N, L) with N divisible by the axis size; ``w``: (N,) row mask
    (0 = padding/excluded).  Each rank moves its rows to ``mesh.device``;
    the returned model is the full one on every rank.  Collectives: four
    all-reduces (count and sum, the (L, L) scatter, the score sum and the
    (k, k) score scatter) and one gather of the per-sample T^2, Q and mask
    for the limit engines.  ``solver='rsvd'`` replaces the replicated
    dense eigh of the reduced covariance by the randomized subspace fit
    (test matrix ``omega``), the residual moments by covariance deflation.
    """
    _check_solver(solver)
    require_mesh_axis(mesh, axis)
    x_loc = shard_batch(x, mesh, axis, "x")
    require_f32(x_loc.dtype, x_loc.device, K1, "fit_simca_sharded")
    w_loc = shard_batch(np.asarray(w) if not isinstance(w, torch.Tensor)
                        else w, mesh, axis, "w").to(x_loc.dtype)
    n_features = x_loc.shape[1]
    k = n_components

    # ---- all-reduced class statistics ---------------------------------
    n, sum_x = mesh.psum([w_loc.sum()[None],
                          (x_loc * w_loc[:, None]).sum(0)], axis,
                         "count+sum")
    n = n[0]
    mean = sum_x / n
    xc = (x_loc - mean[None, :]) * w_loc[:, None]
    with full_f32_matmul():
        c = mesh.psum(xc.T @ xc, axis, "scatter") / (n - 1.0)
        # ---- replicated decomposition ---------------------------------
        if solver == "rsvd":
            s_sub = min(k + oversample, n_features)
            eigval, eigvec = pca_topk_cov(c, s_sub, iters=subspace_iters,
                                          omega=omega)
        else:
            eigval, eigvec = eigh_desc_signed(c)
        p = eigvec[:, :k].T
        # ---- sharded scores, all-reduced score covariance -------------
        t = xc @ p.T
        tm = mesh.psum((t * w_loc[:, None]).sum(0), axis, "score sum") / n
        tc = (t - tm[None, :]) * w_loc[:, None]
        invcovT = pinv_psd(mesh.psum(tc.T @ tc, axis, "score scatter")
                           / (n - 1.0))
        t2_loc = ((t @ invcovT) * t).sum(-1)
        q_loc = ((xc * xc).sum(-1) - (t * t).sum(-1)).clamp_min(0.0)

    # ---- limits on the gathered train statistics (N scalars) ----------
    t2_all, q_all, w_all = mesh.all_gather(
        torch.stack([t2_loc, q_loc, w_loc]), axis, "t2+q+w", dim=1)
    max_rank = n.clamp_max(n_features).to(torch.int64)
    if solver == "rsvd":
        thetas = deflated_thetas(c, eigval, eigvec, k)
    else:
        thetas = L.residual_thetas(eigval, k, max_rank=max_rank)
    t2_res = masked_t2_limit(t2_all, w_all, n, k, t2_method, t2_cl)
    q_res = masked_q_limit(q_all, w_all, n, q_method, q_cl, thetas)
    d_limit = L.critical_distance(decision_type, t2_res, q_res,
                                  n_components=k, thetas=thetas, dcl=d_cl)
    return SIMCAModel(
        mean=mean, components=p, invcovT=invcovT, eigenvalues=eigval,
        t2_res=t2_res, q_res=q_res, d_limit=d_limit,
        t2_train=torch.where(w_all > 0, t2_all, 0.0),
        q_train=torch.where(w_all > 0, q_all, 0.0),
        n_samples=n.to(torch.int64))


def predict_sharded(model: SIMCAModel, x, mesh: Mesh,
                    decision_type: str = "alt", axis: str = DATA_AXIS):
    """Sharded batch scoring: this rank scores its rows of ``x`` against the
    model (on ``mesh.device``; kernel K1 on the card), with no collective.

    Returns this rank's (accept, dred, t2, q), the sample-sharded outputs
    of the reference.
    """
    require_mesh_axis(mesh, axis)
    x_loc = shard_batch(x, mesh, axis, "x")
    return simca_decide(_moved(model, mesh.device), x_loc, decision_type)


def moments_update_sharded(mom: SpectraMoments, x, mesh: Mesh, w=None,
                           axis: str = DATA_AXIS) -> SpectraMoments:
    """Sharded streaming ingest: fold a sample-sharded batch into a
    replicated ``models.streaming.SpectraMoments`` (on ``mesh.device``).

    The only cross-rank traffic is the batch count and sum (one round) and
    the (L, L) scatter (a second): independent of the batch size.  The
    same sums as the local ``moments_update`` in a different order.  Rows
    pad to the axis size (edge repeats under a zero mask), so any batch
    size works.
    """
    require_mesh_axis(mesh, axis)
    mom = _moved(mom, mesh.device)
    dt = mom.mean.dtype
    n = x.shape[0]
    if isinstance(x, torch.Tensor):
        w = torch.ones(n, dtype=dt, device=x.device) if w is None \
            else torch.as_tensor(w, dtype=dt, device=x.device)
        pad = (-n) % mesh.shape[axis]
        x_p = torch.cat([x, x[-1:].expand(pad, -1)])
        w_p = torch.cat([w, w.new_zeros(pad)])   # padded rows must not count
    else:
        x_p, _ = pad_to_multiple(np.asarray(x), mesh.shape[axis])
        w_p = np.zeros(x_p.shape[0])
        w_p[:n] = 1.0 if w is None else np.asarray(w, np.float64)
    x_loc = shard_batch(x_p, mesh, axis, "x").to(dt)
    w_loc = shard_batch(w_p, mesh, axis, "w").to(dt)
    nb, sum_x = mesh.psum([w_loc.sum()[None], (w_loc[:, None] * x_loc)
                           .sum(0)], axis, "count+sum")
    nb = nb[0]
    mu_b = sum_x / torch.where(nb > 0, nb, 1.0)
    xc = (x_loc - mu_b[None, :]) * torch.sqrt(w_loc)[:, None]
    with full_f32_matmul():
        scatter_b = mesh.psum(xc.T @ xc, axis, "scatter")
    return moments_merge(mom, SpectraMoments(nb, mu_b, scatter_b))


def _unit_sweep(x, trains, helds, others, lvs, mesh, model_axis, kw):
    """Every rank's slice of the (padded) fit units through
    ``fold_lv_sweep``; returns the gathered (accept, spec)."""
    sl = mesh.rows(trains.shape[0], model_axis)
    mesh.note_shard("train", model_axis, trains[sl].shape, trains.shape)
    tr, he, ot = (torch.as_tensor(np.ascontiguousarray(a[sl]),
                                  device=x.device)
                  for a in (trains, helds, others))
    sweep = cv_mod.fold_lv_sweep(x, tr, he, ot, lvs, **kw)
    return (mesh.all_gather(sweep.accept, model_axis, "accept"),
            mesh.all_gather(sweep.spec, model_axis, "spec"))


def _sweep_kw(x, lv_values, solver, oversample, subspace_iters,
              decision_type, t2_method, q_method, t2_cl, q_cl, d_cl, side,
              omega):
    if decision_type == "dd":
        t2_method = q_method = "chi2pom"
    return dict(solver=solver,
                n_sub=min(int(max(lv_values)) + oversample, x.shape[1]),
                subspace_iters=subspace_iters, decision_type=decision_type,
                t2_method=t2_method, q_method=q_method, t2_cl=t2_cl,
                q_cl=q_cl, d_cl=d_cl, side=side, omega=omega)


def cv_sweep_sharded(x, y, cls_label, lv_values, mesh: Mesh,
                     n_splits: int = 5, model_axis: str = MODEL_AXIS,
                     decision_type: str = "alt", t2_method: str = "Fdist",
                     q_method: str = "jm", t2_cl: float = 0.95,
                     q_cl: float = 0.95, d_cl: float = 0.95,
                     solver: str = "eigh", oversample: int = 10,
                     subspace_iters: int = 4, side: str = "auto",
                     hlo_sink=None, omega=None) -> dict:
    """CV fold axis sharded over ``mesh[model_axis]``: distinct fold fits on
    distinct ranks, each through ``models.cv.fold_lv_sweep`` (the local
    sweep's code and defaults).  Folds pad cyclically to the axis size;
    padded folds compute real fits and are dropped from every aggregate.
    The only collectives gather the decisions and fold specificities.
    Returns ``cv_simca_sweep``'s ``pred``/``sens``/``spec``/``eff`` (numpy)
    on every rank.
    """
    _check_solver(solver)
    require_mesh_axis(mesh, model_axis)
    with mesh.recording(hlo_sink):
        x = as_tensor(x, mesh.device)
        y_np = np.asarray(y)
        train_np, held_np = cv_mod.fold_masks(y_np, cls_label, n_splits)
        (train_p, held_p), _ = cyclic_pad((train_np, held_np),
                                          mesh.shape[model_axis])
        other = y_np != cls_label
        lvs = torch.as_tensor(list(lv_values), dtype=torch.int64,
                              device=x.device)
        kw = _sweep_kw(x, lv_values, solver, oversample, subspace_iters,
                       decision_type, t2_method, q_method, t2_cl, q_cl, d_cl,
                       side, omega)
        accept, spec = _unit_sweep(
            x, train_p, held_p, np.broadcast_to(other, train_p.shape), lvs,
            mesh, model_axis, kw)
        out = cv_mod.pooled_aggregate(
            accept[:n_splits], spec[:n_splits],
            torch.as_tensor(held_np, device=x.device),
            torch.as_tensor(other, device=x.device), x.dtype)
    return cv_mod._to_numpy(out)


def cv_sweep_sharded_multiclass(x, y, class_labels, lv_values, mesh: Mesh,
                                n_splits: int = 5,
                                model_axis: str = MODEL_AXIS,
                                decision_type: str = "alt",
                                t2_method: str = "Fdist",
                                q_method: str = "jm", t2_cl: float = 0.95,
                                q_cl: float = 0.95, d_cl: float = 0.95,
                                solver: str = "eigh", oversample: int = 10,
                                subspace_iters: int = 4,
                                side: str = "auto", hlo_sink=None,
                                omega=None) -> dict:
    """EVERY class's CV sweep with the flattened (class x fold) axis sharded
    over ``mesh[model_axis]``: C classes x F folds are C*F independent fit
    units, padded cyclically to the axis size, each rank's units through
    ``fold_lv_sweep``; per-class pooled aggregation runs on every rank.
    Row c equals ``cv_simca_sweep_multiclass``'s.
    """
    _check_solver(solver)
    require_mesh_axis(mesh, model_axis)
    with mesh.recording(hlo_sink):
        x = as_tensor(x, mesh.device)
        y_np = np.asarray(y)
        n_classes = len(class_labels)
        masks = [cv_mod.fold_masks(y_np, c, n_splits) for c in class_labels]
        others = np.stack([y_np != c for c in class_labels])
        flat_train = np.concatenate([m[0] for m in masks])   # (C*F, N)
        flat_held = np.concatenate([m[1] for m in masks])
        flat_other = np.repeat(others, n_splits, axis=0)
        n_units = flat_train.shape[0]
        (flat_train, flat_held, flat_other), _ = cyclic_pad(
            (flat_train, flat_held, flat_other), mesh.shape[model_axis])
        lvs = torch.as_tensor(list(lv_values), dtype=torch.int64,
                              device=x.device)
        kw = _sweep_kw(x, lv_values, solver, oversample, subspace_iters,
                       decision_type, t2_method, q_method, t2_cl, q_cl, d_cl,
                       side, omega)
        accept, spec = _unit_sweep(x, flat_train, flat_held, flat_other, lvs,
                                   mesh, model_axis, kw)
        accept = accept[:n_units].reshape(n_classes, n_splits,
                                          *accept.shape[1:])
        spec = spec[:n_units].reshape(n_classes, n_splits, -1)
        dev = x.device
        out = cv_mod.pooled_aggregate(
            accept, spec,
            torch.as_tensor(np.stack([m[1] for m in masks]), device=dev),
            torch.as_tensor(others, device=dev), x.dtype)
    return cv_mod._to_numpy(out)


def cv_sweep_sharded_2d(x, y, cls_label, lv_values, mesh: Mesh,
                        n_splits: int = 5, model_axis: str = MODEL_AXIS,
                        data_axis: str = DATA_AXIS,
                        decision_type: str = "alt", t2_method: str = "Fdist",
                        q_method: str = "jm", t2_cl: float = 0.95,
                        q_cl: float = 0.95, d_cl: float = 0.95,
                        solver: str = "eigh", oversample: int = 10,
                        subspace_iters: int = 4, hlo_sink=None,
                        omega=None) -> dict:
    """CV sweep on a 2-D mesh: folds shard over ``model_axis`` AND samples
    over ``data_axis``.

    Each rank computes its folds' partial class statistics on its rows;
    count and sum (one round), the (F/m, L, L) scatter and the confusion
    counts all-reduce over the data axis, and the per-sample train T^2/Q
    and masks gather over it (one round) for the order-statistic limit
    engines.  ``models.cv.lv_t2_q`` and ``lv_limits`` are the local
    sweep's.  Both grid axes auto-pad: samples to the data-axis size with
    rows outside every mask, folds to the model-axis size by cyclic
    repetition (dropped from every aggregate).  The decomposition is on
    the covariance side.
    """
    _check_solver(solver)
    require_mesh_axis(mesh, model_axis)
    require_mesh_axis(mesh, data_axis)
    with mesh.recording(hlo_sink):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y_np = np.asarray(y)
        n = x.shape[0]
        n_data = mesh.shape[data_axis]
        if decision_type == "dd":
            t2_method = q_method = "chi2pom"
        train_np, held_np = cv_mod.fold_masks(y_np, cls_label, n_splits)
        (train_p, held_p), _ = cyclic_pad((train_np, held_np),
                                          mesh.shape[model_axis])
        other_np = y_np != cls_label
        valid_np = np.ones(n, dtype=bool)
        pad = (-n) % n_data
        if pad:
            x = np.concatenate([x, np.zeros((pad, x.shape[1]), x.dtype)])
            zeros_f = np.zeros((train_p.shape[0], pad), dtype=bool)
            train_p = np.concatenate([train_p, zeros_f], axis=1)
            held_p = np.concatenate([held_p, zeros_f], axis=1)
            other_p = np.concatenate([other_np, np.ones(pad, dtype=bool)])
            valid_p = np.concatenate([valid_np, np.zeros(pad, dtype=bool)])
        else:
            other_p, valid_p = other_np, valid_np
        x_loc = shard_batch(x, mesh, data_axis, "x")
        dev, dt = x_loc.device, x_loc.dtype
        rows = mesh.rows(x.shape[0], data_axis)
        folds = mesh.rows(train_p.shape[0], model_axis)
        tr, he = (torch.as_tensor(a[folds, rows], device=dev)
                  for a in (train_p, held_p))
        mesh.note_shard("train", f"{model_axis},{data_axis}", tr.shape,
                        train_p.shape)
        other_loc = torch.as_tensor(other_p[rows], device=dev)
        valid_loc = torch.as_tensor(valid_p[rows], device=dev)
        lvs = torch.as_tensor(list(lv_values), dtype=torch.int64, device=dev)
        n_features = x.shape[1]

        # per local fold (a leading axis F/m), reduced over the data axis
        w = tr.to(dt)                                        # (F/m, N/d)
        n_f, sum_x = mesh.psum([w.sum(-1), (w @ x_loc).reshape(-1)],
                               data_axis, "count+sum")
        mean = sum_x.view(w.shape[0], -1) / n_f[:, None]
        xc = x_loc - mean[:, None, :]                        # (F/m, N/d, L)
        xc_w = xc * w[..., None]
        with full_f32_matmul():
            c = (mesh.psum(xc_w.mT @ xc_w, data_axis, "scatter")
                 / (n_f - 1.0)[:, None, None])
            if solver == "rsvd":
                n_sub = min(int(max(lv_values)) + oversample, n_features)
                eigval, eigvec = pca_topk_cov(c, n_sub, iters=subspace_iters,
                                              omega=omega)
                tab = deflated_theta_tables(c, eigval, eigvec)
                tab = ThetaTables(*(a[..., None] for a in tab[:3]),
                                  *(a[..., None, :] for a in tab[3:]))
                thetas = thetas_from_tables(tab, lvs)
            else:
                eigval, eigvec = eigh_desc_signed(c)
                max_rank = n_f.clamp_max(n_features).to(torch.int64)
                thetas = L.residual_thetas(eigval[..., None, :], lvs,
                                           max_rank=max_rank[..., None])
            t_all = xc @ eigvec[..., :int(lvs.max())]
        t2_loc, q_loc = cv_mod.lv_t2_q(eigval, t_all, (xc * xc).sum(-1),
                                       lvs)                  # (F/m, nLV, N/d)
        # the per-sample train statistics, gathered for the limit engines
        g = mesh.all_gather(torch.cat([t2_loc * w[:, None, :],
                                       q_loc * w[:, None, :],
                                       w[:, None, :]], 1),
                            data_axis, "t2+q+w", dim=-1)
        n_lv = lvs.shape[0]
        t2_g, q_g, w_g = g[:, :n_lv], g[:, n_lv:2 * n_lv], g[:, -1:]
        t2_res, q_res, d_limit = cv_mod.lv_limits(
            t2_g, q_g, w_g, n_f[:, None], lvs, thetas, decision_type,
            t2_method, q_method, t2_cl, q_cl, d_cl)
        dred = L.reduced_distance(decision_type, t2_loc, q_loc, t2_res,
                                  q_res)
        accept = dred < d_limit[..., None]
        held_ = he[:, None, :]
        test = ((he | other_loc) & valid_loc)[:, None, :]
        # the fold specificity's counts (sens comes from the pooled
        # predictions, pooled_aggregate)
        fp, tn = mesh.psum(torch.stack([
            (accept & ~held_ & test).sum(-1),
            (~accept & ~held_ & test).sum(-1)]).to(dt), data_axis,
            "fp+tn")
        spec = tn / (tn + fp) * 100.0
        accept = mesh.all_gather(mesh.all_gather(accept, data_axis, "accept",
                                                 dim=-1),
                                 model_axis, "accept")
        spec = mesh.all_gather(spec, model_axis, "spec")
        out = cv_mod.pooled_aggregate(
            accept[:n_splits, :, :n], spec[:n_splits],
            torch.as_tensor(held_np, device=dev),
            torch.as_tensor(other_np, device=dev), dt)
    return cv_mod._to_numpy(out)


__all__ = ["fit_simca_sharded", "predict_sharded", "moments_update_sharded",
           "cv_sweep_sharded", "cv_sweep_sharded_multiclass",
           "cv_sweep_sharded_2d"]
