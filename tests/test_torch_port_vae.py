"""The port's ConvVAE1D (``ocm_tpu_torch.models.vae``) and bundle against
``ocm_tpu``, float64 on the CPU.

The JAX model is ``ConvVAE1D(dtype=float64, bn_impl='fused')`` (its
BatchNorm through the Pallas kernels in interpret mode) with its f32 init
cast to f64; the weight carrier ``vae_state_dict_from_numpy`` brings the
same tree into the port.  Noise is passed in explicitly on both sides.
Tolerance: 1e-9 relative (f64; convolutions and sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ocm_tpu.models import bundle as JBd
from ocm_tpu.models import vae as JV
from ocm_tpu.models.torch_export import numpy_state_dict_from_bundle
from ocm_tpu_torch.models import bundle as TBd
from ocm_tpu_torch.models import vae as TV
from ocm_tpu_torch.utils import profiling
from torch_port_data import (VAE_ENTRY, VAE_SMALL, eval_kernel_on_cpu,
                             perturb_bn, vae_spectra)

RTOL, ATOL = 1e-9, 1e-11
DECISION_BUFFERS = {"threshold", "threshold_q", "threshold_h", "threshold_f",
                    "spec_mean", "spec_std", "latent_mean", "latent_cov_inv"}


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@functools.lru_cache(maxsize=None)
def _jax_model(**kw):
    """(JAX module, f64 params, f64 batch stats) from init_vae(key 0)."""
    model = JV.ConvVAE1D(**kw, dtype=jnp.float64, bn_impl="fused")
    params, stats = (_f64(t) for t in JV.init_vae(model, jax.random.key(0)))
    if stats:
        params, stats = perturb_bn(params, stats)
    return model, params, stats


def _port_model(params, stats, **kw):
    model = TV.ConvVAE1D(**kw).double()
    model.load_state_dict(TV.vae_state_dict_from_numpy(params, stats, model),
                          strict=True)
    return model


def _jax_fwd(mod, x, eps, train):
    mu, lv = mod.encode(x, train=train)
    return mod.decode(mu + eps * jnp.exp(0.5 * lv), train=train), mu, lv


def _close(got, ref, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("kw", [dict(input_length=501, kernel_size=9,
                                     stride=2, conv_blocks=3, n_filters=32),
                                dict(input_length=40, kernel_size=5,
                                     stride=3, conv_blocks=4, n_filters=600)],
                         ids=["entry", "odd"])
def test_shapes_match_jax(kw):
    assert TV.encoder_shapes(**kw) == JV.encoder_shapes(**kw)
    assert TV.conv_out_length(kw["input_length"], kw["kernel_size"],
                              kw["stride"]) == JV.conv_out_length(
        kw["input_length"], kw["kernel_size"], kw["stride"])


@pytest.mark.parametrize("act", ["elu", "gelu"])
def test_batchnorm_act_module_matches_jax(act):
    rng = np.random.default_rng(0)
    x = rng.normal(0.2, 1.3, size=(6, 5, 11))                 # (B, C, L)
    x_cl = jnp.asarray(np.swapaxes(x, 1, 2))
    jmod = JV.BatchNormAct(act=act, dtype=jnp.float64, impl="fused")
    params = {"scale": rng.uniform(0.5, 1.5, 5), "bias": rng.normal(size=5)}
    stats = {"mean": rng.normal(size=5), "var": rng.uniform(0.5, 2.0, 5)}
    out_r, mut = jmod.apply({"params": params, "batch_stats": stats}, x_cl,
                            train=True, mutable=["batch_stats"])
    eval_r = jmod.apply({"params": params, "batch_stats": stats}, x_cl,
                        train=False)

    mod = TV.BatchNormAct(5, act).double()
    with torch.no_grad():
        mod.weight.copy_(torch.tensor(params["scale"]))
        mod.bias.copy_(torch.tensor(params["bias"]))
        mod.running_mean.copy_(torch.tensor(stats["mean"]))
        mod.running_var.copy_(torch.tensor(stats["var"]))
    _close(mod.eval()(torch.tensor(x)), np.swapaxes(eval_r, 1, 2), "eval")
    out = mod.train()(torch.tensor(x))
    _close(out, np.swapaxes(out_r, 1, 2), "train out")
    _close(mod.running_mean, mut["batch_stats"]["mean"], "running mean")
    _close(mod.running_var, mut["batch_stats"]["var"], "running var")
    assert int(mod.num_batches_tracked) == 1


@pytest.mark.parametrize("use_bn,dropout", [(True, 0.0), (True, 0.2),
                                            (False, 0.0)])
def test_weight_carrier_matches_torch_export(use_bn, dropout):
    kw = dict(VAE_SMALL, use_batchnorm=use_bn, dropout=dropout)
    jmodel, params, stats = _jax_model(**kw)
    length, latent = kw["input_length"], kw["latent_dim"]
    bundle = JBd.new_bundle(params, stats, np.zeros(length), np.ones(length),
                            latent)
    ref = numpy_state_dict_from_bundle(bundle, jmodel)
    model = TV.ConvVAE1D(**kw).double()
    got = TV.vae_state_dict_from_numpy(params, stats, model)
    assert set(got) == set(ref) - DECISION_BUFFERS
    assert set(got) == set(model.state_dict())
    for key, val in got.items():
        np.testing.assert_array_equal(val.numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_and_losses_match_jax(train):
    jmodel, params, stats = _jax_model(**VAE_SMALL)
    rng = np.random.default_rng(1)
    x = vae_spectra(8, VAE_SMALL["input_length"], seed=3)
    x = (x - x.mean(0)) / x.std(0)
    eps = rng.normal(size=(8, VAE_SMALL["latent_dim"]))
    (x_rec_r, mu_r, lv_r), mut = jmodel.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(eps), train, method=_jax_fwd, mutable=["batch_stats"])

    model = _port_model(params, stats, **VAE_SMALL).train(train)
    x_t = torch.tensor(x)
    x_rec, mu, lv = model(x_t, torch.tensor(eps))
    _close(mu, mu_r, "mu")
    _close(lv, lv_r, "logvar")
    _close(x_rec, x_rec_r, "x_rec")
    for name, (total_r, recon_r, kl_r) in (
            (name, JV.beta_vae_loss(jnp.asarray(x), x_rec_r, mu_r, lv_r,
                                    beta=0.7, loss_type=name))
            for name in JV.LOSS_NAMES):
        total, recon, kl = TV.beta_vae_loss(x_t, x_rec, mu, lv, beta=0.7,
                                            loss_type=name)
        _close(total, total_r, f"{name} total")
        _close(recon, recon_r, f"{name} recon")
        _close(kl, kl_r, f"{name} kl")
    if train:
        sd = model.state_dict()
        for b in range(VAE_SMALL["conv_blocks"]):
            _close(sd[f"encoder_conv.{3 * b + 1}.running_mean"],
                   mut["batch_stats"][f"enc_bn{b}"]["mean"], "running mean")
            _close(sd[f"decoder_conv.{3 * b + 1}.running_var"],
                   mut["batch_stats"][f"dec_bn{b}"]["var"], "running var")


def test_entry_width_forward_matches_jax():
    """The flagship model of ``__graft_entry__.entry()``: catches a wrong
    flatten permutation or transposed-conv flip at full width."""
    jmodel, params, stats = _jax_model(**VAE_ENTRY)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (16, 501))
    eps = rng.normal(size=(16, 16))
    x_rec_r, mu_r, lv_r = jax.jit(lambda v, xx, ee: jmodel.apply(
        v, xx, ee, False, method=_jax_fwd))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(eps))
    model = _port_model(params, stats, **VAE_ENTRY).eval()
    x_rec, mu, lv = model(torch.tensor(x), torch.tensor(eps))
    _close(mu, mu_r, "mu")
    _close(lv, lv_r, "logvar")
    _close(x_rec, x_rec_r, "x_rec")
    total_r = JV.beta_vae_loss(jnp.asarray(x), x_rec_r, mu_r, lv_r,
                               loss_type="cosine")[0]
    _close(TV.beta_vae_loss(torch.tensor(x), x_rec, mu, lv,
                            loss_type="cosine")[0], total_r, "cosine loss")


def test_bundle_functions_match_jax():
    jmodel, params, stats = _jax_model(**VAE_SMALL)
    x = vae_spectra(10, VAE_SMALL["input_length"], seed=4)
    mean, std = JBd.spectral_stats(x)
    t_mean, t_std = TBd.spectral_stats(x)
    np.testing.assert_array_equal(t_mean, mean)
    np.testing.assert_array_equal(t_std, std)
    jb = JBd.new_bundle(params, stats, jnp.asarray(mean), jnp.asarray(std),
                        VAE_SMALL["latent_dim"])
    model = TV.ConvVAE1D(**VAE_SMALL).double()
    tb = TBd.new_bundle(TV.vae_state_dict_from_numpy(params, stats, model),
                        torch.tensor(mean), torch.tensor(std),
                        VAE_SMALL["latent_dim"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rec_r, mu_r = JBd.reconstruct(jmodel, jb, jnp.asarray(x))
    rec, mu = TBd.reconstruct(model, tb, x)
    _close(mu, mu_r, "mu")
    _close(rec, rec_r, "reconstruction")
    eps = np.random.default_rng(2).normal(size=(10, VAE_SMALL["latent_dim"]))
    # JAX's bundle.forward draws its own noise: compare with explicit eps
    x_rec_std, _, _ = jmodel.apply(JBd._variables(jb), JBd.standardize(
        jb, jnp.asarray(x)), jnp.asarray(eps), False, method=_jax_fwd)
    _close(TBd.forward(model, tb, x, eps=eps)[0],
           JBd.unstandardize(jb, x_rec_std), "forward")
    for t in ("latent_mean", "latent_cov_inv", "threshold", "threshold_q"):
        _close(getattr(tb, t), getattr(jb, t), t)
    _close(TBd.unstandardize(tb, TBd.standardize(tb, x)), x, "round trip")
    # the bundle functions run on a bound copy under inference mode: no
    # graph is kept, and the caller's module is neither reloaded nor
    # switched to eval mode
    outs = (*TBd.encode(model, tb, x), TBd.decode(model, tb, mu),
            *TBd.forward(model, tb, x, eps=eps), rec)
    assert all(torch.is_inference(o) and not o.requires_grad for o in outs)
    assert model.training
    for key, val in model.state_dict().items():
        assert torch.equal(val, before[key]), key


def test_dropout_draws_from_the_model_generator():
    model = TV.ConvVAE1D(**VAE_SMALL, dropout=0.25)
    drop = model.fc[2]
    x = torch.ones(200, 32, dtype=torch.float64)
    model.train()
    model.dropout_generator = torch.Generator().manual_seed(3)
    a = drop(x)
    model.dropout_generator = torch.Generator().manual_seed(3)
    b = drop(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(torch.unique(a).tolist()) == {0.0, 1.0 / 0.75}
    assert abs((a > 0).double().mean().item() - 0.75) < 0.02
    torch.testing.assert_close(drop.eval()(x), x)


def test_init_is_kaiming_normal_from_the_generator():
    a = TV.ConvVAE1D(**VAE_ENTRY, generator=torch.Generator().manual_seed(1))
    b = TV.ConvVAE1D(**VAE_ENTRY, generator=torch.Generator().manual_seed(1))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    w = a.encoder_conv[3].weight                       # Conv1d(32, 64, 9)
    assert abs(w.std().item() * np.sqrt(32 * 9) - 1.0) < 0.03
    wt = a.decoder_conv[0].weight                      # ConvTranspose1d(128, 64)
    assert abs(wt.std().item() * np.sqrt(64 * 9) - 1.0) < 0.03
    assert float(a.fc[0].bias.detach().abs().max()) == 0.0


# --- the eval-mode conv blocks: conv, then bn_act_eval (K9 on the card) ------

def _eval_model(length=48, act="elu", dtype=torch.float64, **kw):
    """An eval-mode port model with random BatchNorm parameters and running
    statistics (``perturb_bn``'s recipe), nothing requiring grad."""
    model = TV.ConvVAE1D(**{**VAE_SMALL, "input_length": length, **kw},
                         activation=act,
                         generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, TV.BatchNormAct):
                c = mod.weight.shape[0]
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0, 0.3, generator=gen)
                mod.running_mean.normal_(0, 0.3, generator=gen)
                mod.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
            elif isinstance(mod, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
                mod.bias.normal_(0, 0.3, generator=gen)
    return model.to(dtype).eval().requires_grad_(False)


def _module_chain(model, x):
    """(mu, logvar, x_rec of mu) through the modules' own forwards: each
    conv with its bias, then ``BatchNormAct`` (``bn_act_normalize``)."""
    h = model.fc(model.encoder_conv(x.unsqueeze(1)).flatten(1))
    mu, lv = model.fc_mu(h), model.fc_logvar(h)
    h = model.fc_dec(mu).view(mu.shape[0], *model.enc_shape)
    rec = model.decoder_conv(h).squeeze(1)
    n = model.input_length
    rec = rec[..., :n] if rec.shape[-1] > n else F.pad(rec, (0,
                                                             n - rec.shape[-1]))
    return mu, lv, rec


def _new_path(model, x):
    mu, lv = model.encode(x)
    return mu, lv, model.decode(mu)


def _eval_counts(fn):
    profiling.reset()
    with profiling.tracing():
        out = fn()
    c = profiling.counters()
    profiling.reset()
    return out, (c.get("model.bn_act_eval_fused", 0),
                 c.get("model.bn_act_eval_plain", 0))


@pytest.mark.parametrize("length", [48, 51], ids=["L48", "L51"])
@pytest.mark.parametrize("act", ["elu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_eval_conv_blocks_equal_the_module_chain(dtype, act, length):
    """encode and decode in eval mode give the bits of the modules' own
    chain (biased conv, then ``bn_act_normalize``), through
    ``bn_act_eval``'s plain twin on the CPU."""
    model = _eval_model(length, act, dtype)
    x = torch.randn(6, length, generator=torch.Generator().manual_seed(5),
                    dtype=dtype)
    got, counts = _eval_counts(lambda: _new_path(model, x))
    for g, r in zip(got, _module_chain(model, x)):
        assert torch.equal(g, r)
    assert counts == (0, 2 * VAE_SMALL["conv_blocks"])


def test_eval_fused_blocks_match_the_module_chain(monkeypatch):
    """With the kernel pointed at the CPU (a stand-in in its operation
    order), every eval conv block of an f32 model runs as the conv without
    its bias and one kernel call; the convs' arguments (stride, padding,
    output padding) are the modules'.  The CPU's convolution adds its bias
    inside the sum, so the two agree to f32 rounding here (on the card,
    where the bias is a pass of its own, to the bit)."""
    eval_kernel_on_cpu(monkeypatch)
    for length in (48, 51):
        model = _eval_model(length, dtype=torch.float32)
        x = torch.randn(6, length, generator=torch.Generator().manual_seed(7))
        got, counts = _eval_counts(lambda: _new_path(model, x))
        assert counts == (2 * VAE_SMALL["conv_blocks"], 0)
        for g, r in zip(got, _module_chain(model, x)):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


# fallback -> (model, input and context for a forward on the plain path)
FALLBACKS = ["grad", "f64", "bf16_twin"]


@pytest.mark.parametrize("case", FALLBACKS)
def test_eval_fallbacks_take_the_plain_path(monkeypatch, case):
    """Where the kernel cannot take a block (a graph to record, float64,
    the bf16 twin's autocast), the block runs as the modules did before,
    bit for bit, and counts ``model.bn_act_eval_plain``."""
    from ocm_tpu_torch.serving import _Bf16Twin

    eval_kernel_on_cpu(monkeypatch)
    model = _eval_model(dtype=torch.float64 if case == "f64"
                        else torch.float32)
    x = torch.randn(6, 48, generator=torch.Generator().manual_seed(8),
                    dtype=torch.float64 if case == "f64" else torch.float32)
    if case == "grad":
        model.requires_grad_(True)
    if case == "bf16_twin":
        model.bound_state = None
        twin = _Bf16Twin(model)

        def new():
            mu, lv = twin.encode(x)
            return mu, lv, twin.decode(mu)

        def ref():
            with torch.autocast("cpu", dtype=torch.bfloat16):
                out = _module_chain(model, x)
            return [o.to(x.dtype) for o in out]
    else:
        def new():
            return _new_path(model, x)

        def ref():
            return _module_chain(model, x)
    got, counts = _eval_counts(new)
    assert counts == (0, 2 * VAE_SMALL["conv_blocks"])
    for g, r in zip(got, ref()):
        assert torch.equal(g, r)
    assert all(g.requires_grad == (case == "grad") for g in got)


@pytest.mark.parametrize("case", ["no_batchnorm", "train"])
def test_eval_path_leaves_other_forwards_alone(monkeypatch, case):
    """A model without BatchNorm, and training mode, run their modules as
    they are: no eval epilogue, the same bits."""
    eval_kernel_on_cpu(monkeypatch)
    model = _eval_model(dtype=torch.float32,
                        use_batchnorm=case != "no_batchnorm")
    if case == "train":
        model.train()
    x = torch.randn(6, 48, generator=torch.Generator().manual_seed(9))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    got, counts = _eval_counts(lambda: _new_path(model, x))
    model.load_state_dict(state)                 # training moved the stats
    assert counts == (0, 0)
    for g, r in zip(got, _module_chain(model, x)):
        assert torch.equal(g, r)
