"""Reports and plots (port of ``ocm_tpu/utils/report.py``): T2-Q
acceptance planes, CV curves, confusion heatmaps, training curves and the
segmentation figures.

A host-side presentation layer: every plot takes numpy arrays or tensors
(on any device; they are fetched).  It mirrors the reference's figure set:

- T2-Q plane with the 'alt' quarter-circle acceptance boundary
  ``sqrt(Dlim^2 - a^2)`` (utils/SIMCA.py:280-307 ``toplotT2Q``; iterative
  multi-class variant :310-381, rendered with matplotlib, and with plotly
  by ``plot_t2q_interactive`` where plotly is installed);
- CV metric-vs-LV curve with the best-LV marker (utils/CVSIMCA.py:274-331
  ``plot_cv``);
- 2 x C confusion heatmap (simca_new_cheese.py:103-125,
  utils/final_vaesimca.py:544-553);
- train/val loss curves (vae_simca_nuts_peanut.py:421-430);
- segmentation and extraction debug figures (nut_data.py:75-129).

matplotlib is imported lazily with the Agg backend, so nothing else needs
it or a display.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A plot input as a numpy array (a tensor is fetched from its
    device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_t2q(t2_red, q_red, labels=None, d_limit: float = np.sqrt(2.0),
             decision_type: str = "alt", log_scale: bool = False,
             title: str = "T2-Q acceptance plane",
             save_path: Optional[str] = None):
    """Scatter of reduced (T2, Q) with the acceptance boundary
    (utils/SIMCA.py:280-307).

    For 'alt' the boundary is the quarter circle q = sqrt(Dlim^2 - t^2);
    for 'sim' the square [0,Dlim]^2 edge; for 'ci'/'dd' the line
    t + q = Dlim in reduced coordinates.
    """
    plt = _plt()
    t2_red = _np(t2_red)
    q_red = _np(q_red)
    d_limit = float(d_limit)
    fig, ax = plt.subplots(figsize=(7, 6))
    if labels is None:
        ax.scatter(t2_red, q_red, s=12, alpha=0.6)
    else:
        labels = _np(labels)
        for cls in np.unique(labels):
            m = labels == cls
            ax.scatter(t2_red[m], q_red[m], s=12, alpha=0.6,
                       label=f"class {cls}")
        ax.legend()
    if decision_type == "alt":
        a = np.linspace(0, d_limit, 200)
        ax.plot(a, np.sqrt(np.maximum(d_limit**2 - a**2, 0.0)), "r--",
                label="boundary")
    elif decision_type == "sim":
        ax.plot([0, d_limit, d_limit], [d_limit, d_limit, 0], "r--")
    else:
        a = np.linspace(0, d_limit, 200)
        ax.plot(a, d_limit - a, "r--")
    if log_scale:
        ax.set_xscale("log")
        ax.set_yscale("log")
    ax.set_xlabel("T2 / T2_lim")
    ax.set_ylabel("Q / Q_lim")
    ax.set_title(title)
    ax.grid(True, linestyle="--", alpha=0.5)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def plot_t2q_classes(models: Mapping, transform_fn, x, labels,
                     decision_type: str = "alt",
                     save_path: Optional[str] = None):
    """Multi-class T2-Q panel (utils/SIMCA.py:310-381): one subplot per
    fitted class model; ``transform_fn(cls, x) -> (t2_red, q_red,
    d_limit)``."""
    plt = _plt()
    classes = list(models)
    fig, axes = plt.subplots(1, len(classes),
                             figsize=(6 * len(classes), 5), squeeze=False)
    for ax, cls in zip(axes[0], classes):
        t2_red, q_red, d_limit = transform_fn(cls, x)
        d_limit = float(d_limit)
        for lab in np.unique(_np(labels)):
            m = _np(labels) == lab
            ax.scatter(_np(t2_red)[m], _np(q_red)[m], s=10,
                       alpha=0.6, label=f"class {lab}")
        a = np.linspace(0, d_limit, 200)
        if decision_type == "alt":
            ax.plot(a, np.sqrt(np.maximum(d_limit**2 - a**2, 0.0)), "r--")
        else:
            ax.plot(a, d_limit - a, "r--")
        ax.set_title(f"model class {cls}")
        ax.set_xlabel("T2 red")
        ax.set_ylabel("Q red")
        ax.legend(fontsize=7)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def plot_cv(res: Mapping, metric: str = "eff", params: Optional[dict] = None,
            show_best: bool = True, title: Optional[str] = None,
            save_path: Optional[str] = None):
    """CV metric vs #LV with best-LV marker (utils/CVSIMCA.py:274-331).

    ``res`` is the dict returned by
    ocm_tpu_torch.models.cv.cross_validate_simca_grid.
    """
    plt = _plt()
    results = res["results"]
    if params is None:
        params = res.get("best_params")

    def match(r):
        return all(r["params"].get(k) == v for k, v in (params or {}).items())

    selected = sorted((r for r in results if match(r)), key=lambda r: r["LV"])
    if not selected:
        raise ValueError("no CV records match the given params")
    lv = np.array([r["LV"] for r in selected])
    vals = np.array([r[metric] for r in selected])

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(lv, vals, marker="o", label=f"mean CV {metric.upper()}")
    if show_best and "best_LV" in res:
        ax.axvline(res["best_LV"], color="r", linestyle="--",
                   label=f"best LV = {res['best_LV']} "
                         f"({metric} = {res['best_score']:.3f})")
    ax.set_xlabel("number of latent variables (LVs)")
    ax.set_ylabel(metric.upper())
    ax.set_title(title or f"cross-validation {metric.upper()} vs LV")
    ax.grid(True, linestyle="--", alpha=0.5)
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def plot_confusion(conf_mat, true_labels: Sequence,
                   pred_labels: Sequence = ("conform", "unconform"),
                   title: str = "confusion matrix",
                   save_path: Optional[str] = None):
    """2 x C confusion heatmap (utils/final_vaesimca.py:544-553)."""
    plt = _plt()
    conf = _np(conf_mat)
    fig, ax = plt.subplots(figsize=(1.2 * conf.shape[1] + 2, 3.5))
    im = ax.imshow(conf, cmap="Blues")
    for i in range(conf.shape[0]):
        for j in range(conf.shape[1]):
            ax.text(j, i, str(int(conf[i, j])), ha="center", va="center",
                    color="black")
    ax.set_xticks(range(conf.shape[1]), [str(t) for t in true_labels])
    ax.set_yticks(range(conf.shape[0]), list(pred_labels))
    ax.set_xlabel("true class")
    ax.set_ylabel("predicted")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, shrink=0.8)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def plot_losses(train_losses, val_losses=None, best_epoch: Optional[int] = None,
                title: str = "training curves",
                save_path: Optional[str] = None):
    """Train/val loss curves (vae_simca_nuts_peanut.py:421-430)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(_np(train_losses), label="train")
    if val_losses is not None:
        ax.plot(_np(val_losses), label="val")
    if best_epoch is not None:
        ax.axvline(best_epoch, color="r", linestyle="--",
                   label=f"best epoch {best_epoch}")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(title)
    ax.grid(True, linestyle="--", alpha=0.5)
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def _rgb_composite(cube):
    """RGB composite at the 10/50/90% wavelengths, 1-99 percentile
    stretched (nut_data.py:76-81)."""
    cube = _np(cube)
    length = cube.shape[2]
    idxs = [int(length * 0.1), int(length * 0.5), int(length * 0.9)]
    rgb = np.stack([cube[..., i] for i in idxs], axis=-1)
    p1, p99 = np.percentile(rgb, (1, 99))
    return np.clip((rgb - p1) / (p99 - p1 + 1e-12), 0, 1)


def plot_segmentation(cube, labeled, n_objects: int,
                      title: str = "segmentation",
                      save_path: Optional[str] = None):
    """Per-image segmentation debug figure (nut_data.py:75-103): each
    connected component in a distinct tab20 color on black background,
    object ids drawn at the component centroids.  ``labeled`` comes from
    ``ocm_tpu_torch.utils.io.segment_cube`` (or ``utils.native.label``)."""
    plt = _plt()
    from matplotlib import colormaps

    rgb_vis = _rgb_composite(cube)
    labeled = _np(labeled)
    seg_color = np.zeros_like(rgb_vis)
    cmap = colormaps["tab20"]
    for obj_id in range(1, n_objects + 1):
        seg_color[labeled == obj_id] = cmap((obj_id - 1) % 20)[:3]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(seg_color)
    ax.axis("off")
    ax.set_title(title)
    for obj_id in range(1, n_objects + 1):
        coords = np.argwhere(labeled == obj_id)
        if coords.size == 0:
            continue
        yc, xc = coords.mean(axis=0)
        ax.text(xc, yc, str(obj_id), color="white", fontsize=8,
                ha="center", va="center")
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def plot_extraction(cube, labeled, obj_id: int,
                    title: Optional[str] = None,
                    save_path: Optional[str] = None):
    """Single-object extraction debug figure (nut_data.py:106-129): the
    object's pixels in the RGB composite, everything else black, with a
    yellow bounding box and the object id."""
    plt = _plt()
    from matplotlib.patches import Rectangle
    from scipy import ndimage

    rgb_vis = _rgb_composite(cube)
    labeled = _np(labeled)
    mask = labeled == obj_id
    rgb_masked = np.zeros_like(rgb_vis)
    if mask.any():
        rgb_masked[mask] = rgb_vis[mask]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(rgb_masked)
    ax.axis("off")
    ax.set_title(title or f"object {obj_id}")
    slices = ndimage.find_objects(labeled, max_label=obj_id)
    sl = slices[obj_id - 1] if slices else None
    if sl is not None:
        y0, x0 = sl[0].start, sl[1].start
        h, w = sl[0].stop - y0, sl[1].stop - x0
        ax.add_patch(Rectangle((x0, y0), w, h, linewidth=1,
                               edgecolor="yellow", facecolor="none"))
        ax.text(x0, y0, str(obj_id), color="yellow", fontsize=8)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def plot_t2q_interactive(t2_red, q_red, labels=None,
                         d_limit: float = np.sqrt(2.0),
                         decision_type: str = "alt",
                         title: str = "T2-Q acceptance plane",
                         save_path: Optional[str] = None):
    """Interactive plotly T2-Q plane — the reference's
    ``toplotT2Q_iterative`` twin (utils/SIMCA.py:310-381): per-class
    hoverable scatter traces + the acceptance boundary curve, written to a
    standalone HTML file when ``save_path`` is given.

    plotly is an optional dependency;
    when absent this raises ImportError with a pointer to the matplotlib
    twin ``plot_t2q``, which renders the same figure statically.
    """
    try:
        import plotly.graph_objects as go
        if not hasattr(go, "Figure"):      # partial stub in sys.modules
            raise ImportError("plotly.graph_objects lacks Figure")
    except ImportError as e:
        raise ImportError(
            "plotly is not installed; use ocm_tpu_torch.utils.report.plot_t2q "
            "for the matplotlib rendering of the same figure") from e

    t2_red = _np(t2_red)
    q_red = _np(q_red)
    d_limit = float(d_limit)
    fig = go.Figure()
    if labels is None:
        fig.add_trace(go.Scatter(x=t2_red, y=q_red, mode="markers",
                                 name="samples", opacity=0.6))
    else:
        labels = _np(labels)
        for cls in np.unique(labels):
            m = labels == cls
            fig.add_trace(go.Scatter(
                x=t2_red[m], y=q_red[m], mode="markers",
                name=f"class {cls}", opacity=0.6,
                hovertemplate="T2red=%{x:.3f}<br>Qred=%{y:.3f}"))
    a = np.linspace(0, d_limit, 200)
    if decision_type == "alt":
        boundary = np.sqrt(np.maximum(d_limit**2 - a**2, 0.0))
    elif decision_type == "sim":
        a = np.array([0, d_limit, d_limit])
        boundary = np.array([d_limit, d_limit, 0])
    else:
        boundary = d_limit - a
    fig.add_trace(go.Scatter(x=a, y=boundary, mode="lines",
                             name="boundary", line=dict(dash="dash",
                                                        color="red")))
    fig.update_layout(title=title, xaxis_title="T2 / T2_lim",
                      yaxis_title="Q / Q_lim")
    if save_path:
        fig.write_html(save_path)
        return save_path
    return fig
