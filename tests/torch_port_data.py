"""Seeded inputs shared by the ``test_torch_port_*`` parity tests.

The recipe is ``bench.py:make_data`` at a small size: C classes of smooth
spectra (class-specific sine plus offset, random amplitude, white noise),
and a scored set that mixes fresh draws from every class with spectra of
no class, so that accept matrices hold both decisions.
"""

import numpy as np

N_CAL, LENGTH, N_CLASSES, N_SCORE, K = 120, 60, 3, 500, 4


def class_spectra(rng, c, n, length):
    t = np.linspace(0, 1, length)
    base = np.sin(2 * np.pi * (3 + c) * t) + 0.3 * c
    amp = rng.normal(1.0, 0.08, size=(n, 1))
    return amp * base[None, :] + rng.normal(0, 0.02, size=(n, length))


def make_data(seed=0, n_cal=N_CAL, length=LENGTH, n_classes=N_CLASSES,
              n_score=N_SCORE):
    """(calibration stack (C, n_cal, L), scored spectra (n_score, L)), f64."""
    rng = np.random.default_rng(seed)
    cals = np.stack([class_spectra(rng, c, n_cal, length)
                     for c in range(n_classes)])
    per = n_score // (n_classes + 1)
    parts = [class_spectra(rng, c, per, length) for c in range(n_classes)]
    t = np.linspace(0, 1, length)
    parts.append(rng.normal(0, 0.05, size=(n_score - per * n_classes, length))
                 + np.sin(2 * np.pi * 3 * t)[None, :])
    return cals, np.concatenate(parts)


def simca_numpy_tree(model):
    """A JAX ``SIMCAModel`` as the dict ``save_simca_model`` serializes."""
    return {f: ({k: np.array(a) for k, a in v._asdict().items()}
                if hasattr(v, "_asdict") else np.array(v))
            for f, v in zip(model._fields, model)}


def simca_classes_pair(x, n_classes=N_CLASSES, k=K, solver="rsvd"):
    """JAX's ``fit_classes`` of ``x`` (equal consecutive class blocks, in
    x's dtype) and the same models carried into the port (CPU): the
    serving tests hold both scorers to one set of models."""
    import jax.numpy as jnp

    from ocm_tpu.models import simca as JS
    from ocm_tpu_torch.models import simca as TS

    y = np.repeat(np.arange(n_classes), x.shape[0] // n_classes)
    ref = JS.fit_classes(jnp.asarray(x), y, list(range(n_classes)), k,
                         solver=solver)
    return ref, TS.simca_model_from_numpy(simca_numpy_tree(ref), device="cpu")


def counts_u16(x):
    """Camera counts of spectra ``x``: ``clip(round(5000 (x + 6)))`` as
    uint16, the raw-ingest serving mode's input."""
    return np.clip(np.round(5000.0 * (x + 6.0)), 0, 65535).astype(np.uint16)


# --- the VAE slice ---------------------------------------------------------

# the parity tests' small ConvVAE1D (the entry model is L 501, latent 16,
# 3 blocks, 32 filters, hidden 256)
VAE_SMALL = dict(input_length=48, latent_dim=4, conv_blocks=2, n_filters=8,
                 kernel_size=9, stride=2, hidden_fc=32)
VAE_ENTRY = dict(input_length=501, latent_dim=16, conv_blocks=3, n_filters=32,
                 kernel_size=9, stride=2, hidden_fc=256)


def vae_spectra(n, length, seed=2):
    """``bench_all.py``'s VAE workload recipe (one smooth class), f64."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, length)
    return (rng.normal(1, .08, (n, 1)) * np.sin(2 * np.pi * 3 * t)
            + rng.normal(0, .02, (n, length)))


def vae_classes(n_classes, n_cal=60, n_test_per=30, seed=7):
    """The VAE decision tests' data, f64: per class ``n_cal`` calibration
    spectra (``class_spectra`` at VAE_SMALL's length, each class shifted),
    and a test set of ``n_test_per`` fresh spectra of each of
    ``n_classes + 1`` classes (the last one no model's)."""
    rng = np.random.default_rng(seed)
    length = VAE_SMALL["input_length"]
    cals = [class_spectra(rng, c, n_cal, length) for c in range(n_classes)]
    test = np.concatenate([class_spectra(rng, c, n_test_per, length)
                           for c in range(n_classes + 1)])
    return cals, test


def vae_bundle_pair(x_cal, key=0, bn_seed=5):
    """One class's untrained bundle in both packages: the JAX small model
    (f64) and its bundle from ``init_vae(key)`` with random BatchNorm
    statistics and ``x_cal``'s spectral statistics, and the port's model
    and bundle carried across by ``ocm_bundle_from_numpy`` (CPU, f64).
    Returns (jax_model, jax_bundle, port_model, port_bundle)."""
    import jax
    import jax.numpy as jnp

    from ocm_tpu.models import bundle as JBd
    from ocm_tpu.models import vae as JV
    from ocm_tpu_torch.models import bundle as TBd
    from ocm_tpu_torch.models import vae as TV

    jmodel = JV.ConvVAE1D(**VAE_SMALL, dtype=jnp.float64)
    params, stats = JV.init_vae(jmodel, jax.random.key(key))
    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    params, stats = perturb_bn(f64(params), f64(stats), bn_seed)
    mean, std = JBd.spectral_stats(x_cal)
    jb = JBd.new_bundle(params, stats, jnp.asarray(mean), jnp.asarray(std),
                        VAE_SMALL["latent_dim"])
    tmodel = TV.ConvVAE1D(**VAE_SMALL).double()
    tb = TBd.ocm_bundle_from_numpy(bundle_as_numpy(jb), tmodel, device="cpu")
    return jmodel, jb, tmodel, tb


def bundle_as_numpy(tree):
    """A JAX NamedTuple pytree (bundle or VAESIMCAModel) with numpy leaves."""
    import jax

    return type(tree)(*jax.tree.map(np.asarray, tuple(tree)))


def perturb_bn(params, batch_stats, seed=5):
    """Random BatchNorm scale/bias and running stats (numpy trees), so that
    a test exercises where each of them goes."""
    rng = np.random.default_rng(seed)
    params = {k: dict(v) for k, v in params.items()}
    stats = {}
    for name, s in batch_stats.items():
        c = np.shape(s["mean"])[0]
        params[name] = {"scale": rng.uniform(0.5, 1.5, c),
                        "bias": rng.normal(0, 0.3, c)}
        stats[name] = {"mean": rng.normal(0, 0.3, c),
                       "var": rng.uniform(0.5, 1.5, c)}
    return params, stats


class _AsIfOnCard:
    """A tensor that says it is a CUDA tensor, and is otherwise itself."""
    is_cuda = True

    def __init__(self, x):
        self._x = x

    def __getattr__(self, name):
        return getattr(self._x, name)


def eval_kernel_on_cpu(monkeypatch):
    """Have ``ops.bn.eval_kernel_applies`` (K9's choice) answer for a CPU
    tensor as it answers for the same tensor on the card, so that a CPU
    test sees which conv blocks the card would give the kernel; those then
    run ``bn_act_eval``'s CPU twin, which computes the kernel's operations
    in its order."""
    from ocm_tpu_torch.ops import bn

    applies = bn.eval_kernel_applies
    monkeypatch.setattr(bn, "eval_kernel_applies",
                        lambda x, *params: applies(_AsIfOnCard(x), *params))
